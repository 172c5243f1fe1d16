"""Standard (torchvision-style) ResNet-50: the frozen feature extractor of
the DGP, CNZSL and FREE baselines (port of ``hgr_tpu/models/resnet_std.py``).

The reference's vendored torchvision ResNet (``baseline/DGP/models/
resnet.py``; frozen at ``baseline/FREE/train_free.py:171-186``): a 7x7/2
conv stem and 3x3/2 max pool, post-activation bottlenecks with the stride
on the 3x3 conv, a global average pool to 2,048 features, and an fc head.
``ResNet50`` carries torchvision's ``state_dict`` names (``conv1.weight``,
``bn1.running_mean``, ``layer2.0.downsample.0.weight``, ``fc.weight``), so
a torchvision checkpoint loads as it is (``convert_torch_resnet`` drops
its ``num_batches_tracked`` counters).

The functions keep the JAX package's arithmetic and layout: images are
NHWC at the public functions (NCHW with channels-last strides inside);
master weights stay fp32 and are cast to the compute dtype at use;
eval-mode BatchNorm is folded into one multiply-add; train-mode BatchNorm
(``bn_train``) normalises with the biased batch variance and moves the
running statistics with the unbiased one at momentum 0.1, the semantics of
``torch.nn.BatchNorm2d.train()``. ``resnet50_features_train`` returns those
statistics instead of writing them, and ``apply_bn_stats`` writes them, as
the JAX step folds them into the new parameters after its update.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm, conv2d

LAYERS_50 = (3, 4, 6, 3)
EXP = 4
Stats = Dict[str, Dict[str, torch.Tensor]]


class BatchNorm(nn.Module):
    """Trainable affine parameters and running statistics, torchvision's
    names, no ``num_batches_tracked``. ``path`` is its name in the net."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.path = ""

    def forward(self, y: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        if stats is None:
            return batch_norm(y, self.weight, self.bias, self.running_mean, self.running_var)
        out, stats[self.path] = bn_train(self, y)
        return out


def bn_train(bn: BatchNorm, y: torch.Tensor, momentum: float = 0.1):
    """Train-mode BatchNorm over NCHW ``y`` (``resnet_std.py:114-130``):
    batch mean and biased variance in fp32, applied as one multiply-add in
    ``y``'s dtype; returns ``(out, {"mean", "var"})``, the running
    statistics moved by ``momentum`` with the unbiased variance."""
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    var = yf.var(dim=(0, 2, 3), correction=0)
    inv = torch.rsqrt(var + 1e-5) * bn.weight
    out = y * inv.to(y.dtype)[:, None, None] + (bn.bias - mean * inv).to(y.dtype)[:, None, None]
    n = y.shape[0] * y.shape[2] * y.shape[3]
    unbiased = var.detach() * (n / max(n - 1, 1))
    return out, {"mean": (1 - momentum) * bn.running_mean + momentum * mean.detach(),
                 "var": (1 - momentum) * bn.running_var + momentum * unbiased}


class Conv(nn.Module):
    """Bias-free conv, cast to the input's dtype at use."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride, self.padding = stride, padding

    def init(self, g: torch.Generator) -> None:
        """He-uniform, bound ``sqrt(1 / fan_in)`` (``conv_init``)."""
        bound = math.sqrt(1.0 / self.weight[0].numel())
        with torch.no_grad():
            self.weight.copy_((torch.rand(self.weight.shape, generator=g) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.stride, self.padding)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, stride, 1), BatchNorm(planes)
        self.conv3, self.bn3 = Conv(planes, planes * EXP, 1), BatchNorm(planes * EXP)
        self.downsample = None
        if stride != 1 or cin != planes * EXP:
            self.downsample = nn.Sequential(Conv(cin, planes * EXP, 1, stride),
                                            BatchNorm(planes * EXP))

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), stats))
        out = F.relu(self.bn2(self.conv2(out), stats))
        out = self.bn3(self.conv3(out), stats)
        idn = x
        if self.downsample is not None:
            idn = self.downsample[1](self.downsample[0](x), stats)
        return F.relu(out + idn)


class ResNet50(nn.Module):
    def __init__(self, num_classes: Optional[int] = 1000):
        super().__init__()
        self.conv1, self.bn1 = Conv(3, 64, 7, 2, 3), BatchNorm(64)
        cin = 64
        for li, (blocks, planes) in enumerate(zip(LAYERS_50, (64, 128, 256, 512)), start=1):
            blist = [Bottleneck(cin, planes, 1 if li == 1 else 2)]
            cin = planes * EXP
            blist += [Bottleneck(cin, planes, 1) for _ in range(1, blocks)]
            self.add_module(f"layer{li}", nn.Sequential(*blist))
        self.fc = None if num_classes is None else nn.Linear(2048, num_classes)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.path = name

    def base_parameters(self):
        """Every parameter but the fc head's: what the stage-A' refit trains."""
        return [p for n, p in self.named_parameters() if not n.startswith("fc.")]

    def features(self, x: torch.Tensor, dtype=torch.bfloat16,
                 stats: Optional[Stats] = None) -> torch.Tensor:
        """[B, H, W, 3] -> pooled [B, 2048] in ``dtype``; with ``stats``,
        train-mode BatchNorm whose new running statistics land there."""
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x), stats))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = blk(x, stats)
        return x.mean(dim=(2, 3))


def resnet50_init(g: torch.Generator, num_classes: int = 1000, device=None) -> ResNet50:
    """Random weights with the JAX ``resnet50_init`` distributions (not its
    bits): He-uniform convs, identity BatchNorm, fc ``0.01 * N(0, 1)`` with
    zero bias."""
    model = ResNet50(num_classes)
    for m in model.modules():
        if isinstance(m, Conv):
            m.init(g)
    with torch.no_grad():
        model.fc.weight.copy_(0.01 * torch.randn(model.fc.weight.shape, generator=g))
        model.fc.bias.zero_()
    return model.to(device)


def resnet50_features(model: ResNet50, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[B, H, W, 3] -> [B, 2048], eval-mode BatchNorm (the baselines'
    frozen extractor, ``baseline/CNZSL/cnzsl.py`` feature_encoder)."""
    return model.features(x, dtype)


def resnet50_logits(model: ResNet50, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    f = resnet50_features(model, x, dtype)
    return F.linear(f, model.fc.weight.to(f.dtype), model.fc.bias.to(f.dtype))


def resnet50_features_train(model: ResNet50, x: torch.Tensor, dtype=torch.bfloat16,
                            ) -> Tuple[torch.Tensor, Stats]:
    """Train-mode forward (the reference's stage-A' refit,
    ``baseline/DGP/train_resnet_fit.py:55`` ``model.train()``): BatchNorm
    normalises with batch statistics. Returns ``(features, stats)``, stats
    keyed by the BatchNorm's module name (``layer2.0.downsample.1``); the
    module's running statistics are left as they were."""
    stats: Stats = {}
    return model.features(x, dtype, stats), stats


@torch.no_grad()
def apply_bn_stats(model: ResNet50, stats: Stats) -> ResNet50:
    """Write ``resnet50_features_train``'s running statistics into the
    module's buffers (in place; returns the module)."""
    for path, upd in stats.items():
        bn = model.get_submodule(path)
        bn.running_mean.copy_(upd["mean"])
        bn.running_var.copy_(upd["var"])
    return model


def convert_torch_resnet(sd: Mapping[str, torch.Tensor]) -> ResNet50:
    """A torchvision ResNet-50 ``state_dict`` -> ``ResNet50`` on the CPU in
    fp32; ``num_batches_tracked`` is dropped, and a checkpoint without
    ``fc.weight`` gives a net without a head."""
    sd = {k: v.detach().float() for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model = ResNet50(sd["fc.weight"].shape[0] if "fc.weight" in sd else None)
    model.load_state_dict(sd)
    return model
