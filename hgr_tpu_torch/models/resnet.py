"""Modified ResNet image encoder, CLIP's RN50 family (port of
``hgr_tpu/models/resnet.py``).

Behaviour of the reference ``ModifiedResNet`` (``clip/model.py:94-150``):
3-conv stem with avgpool, anti-aliased strided bottlenecks (avgpool before
the stride-1 conv), frozen-stats BatchNorm, and an attention-pool head that
computes attention for the single mean-token query only (the same output
as the reference's full self-attention read at row 0). Module and
parameter names are OpenAI's (``layer1.0.downsample.0.weight``,
``attnpool.q_proj.weight``, ...). Activations are NCHW; a tensor permuted
from NHWC keeps channels-last strides, which cuDNN takes as they are.

Each BatchNorm runs with what follows it (the residual add, the ReLU, the
2x2 mean, and in a block with a downsample its BatchNorm too) as one call of
K2: ``ops.bn_act.bn_act``, the fused kernel on CUDA, whose output has no
``grad_fn``; where autograd would record the call (the train step,
``ops.ln_act.autograd_records``, the rule every tower asks),
``ops.bn_act.bn_act_autograd``, the same forward as an autograd Function
with K2's backward kernel. On the CPU both run the plain twins
(``layers.batch_norm_act`` and its backward).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import ln_act
from ..ops.bn_act import bn_act, bn_act_autograd
from .layers import BatchNorm2d, Conv2d, Linear, _param, normal_

EXPANSION = 4


def epilogue(x: torch.Tensor, *modules: nn.Module):
    """``bn_act``, or its autograd Function ``bn_act_autograd`` where
    autograd would record the calls (``ops.ln_act.autograd_records``)."""
    return bn_act_autograd if ln_act.autograd_records(x, *modules) else bn_act


class Downsample(nn.Module):
    """The parameters of OpenAI's ``downsample`` Sequential: ``-1`` avgpool
    (none), ``0`` 1x1 conv, ``1`` BN, so the keys are ``downsample.0.weight``
    etc. It has no forward: ``Bottleneck.forward`` pools and convolves the
    block input and folds the BN into the block's last epilogue."""

    def __init__(self, inplanes: int, outplanes: int):
        super().__init__()
        self.add_module("0", Conv2d(inplanes, outplanes, 1))
        self.add_module("1", BatchNorm2d(outplanes))


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNorm2d(planes * EXPANSION)
        self.downsample = None
        if stride > 1 or inplanes != planes * EXPANSION:
            self.downsample = Downsample(inplanes, planes * EXPANSION)

    def init(self, g: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv3):
            conv.init(g)
        for bn in (self.bn1, self.bn2, self.bn3):
            bn.init()
        if self.downsample is not None:
            self.downsample._modules["0"].init(g)
            self.downsample._modules["1"].init()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        epi = epilogue(x, self)
        out = epi(self.conv1(x), self.bn1, relu=True)
        out = epi(self.conv2(out), self.bn2, relu=True, pool=self.stride > 1)
        out = self.conv3(out)
        if self.downsample is None:
            return epi(out, self.bn3, residual=x, relu=True)
        conv, bn = self.downsample._modules["0"], self.downsample._modules["1"]
        idn = epi(x, None, pool=True) if self.stride > 1 else x  # the strides are 1 and 2
        return epi(out, self.bn3, residual=conv(idn), residual_bn=bn, relu=True)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = _param(spacial_dim * spacial_dim + 1, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def init(self, g: torch.Generator) -> None:
        std = self.positional_embedding.shape[1] ** -0.5
        normal_(self.positional_embedding, std, g)
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            lin.init(g, std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] -> [B, output_dim] (mean-token-query pool)."""
        B, C, H, W = x.shape
        tokens = x.flatten(2).transpose(1, 2)            # [B, HW, C]
        mean = tokens.mean(dim=1, keepdim=True)
        tokens = torch.cat([mean, tokens], dim=1)        # [B, HW+1, C]
        tokens = tokens + self.positional_embedding.to(tokens.dtype)

        q = self.q_proj(tokens[:, :1])                   # the mean-token query
        k = self.k_proj(tokens)
        v = self.v_proj(tokens)
        nh, Dh = self.num_heads, C // self.num_heads

        def heads(t):
            return t.view(B, t.shape[1], nh, Dh).transpose(1, 2)

        qh, kh, vh = heads(q), heads(k), heads(v)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        probs = torch.softmax(scores * (Dh ** -0.5), dim=-1)
        out = torch.matmul(probs.to(vh.dtype), vh)       # [B, nh, 1, Dh]
        out = out.transpose(1, 2).reshape(B, 1, C)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(
        self,
        layers: Sequence[int],
        output_dim: int,
        heads: int,
        input_resolution: int = 224,
        width: int = 64,
    ):
        super().__init__()
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1)
        self.bn1 = BatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1)
        self.bn2 = BatchNorm2d(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1)
        self.bn3 = BatchNorm2d(width)
        inplanes = width
        for li, (blocks, planes) in enumerate(
            zip(layers, [width, width * 2, width * 4, width * 8]), start=1
        ):
            stride = 1 if li == 1 else 2
            blist = [Bottleneck(inplanes, planes, stride)]
            inplanes = planes * EXPANSION
            blist += [Bottleneck(inplanes, planes, 1) for _ in range(1, blocks)]
            self.add_module(f"layer{li}", nn.Sequential(*blist))
        self.attnpool = AttentionPool2d(
            input_resolution // 32, width * 32, heads, output_dim
        )

    def init(self, g: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv3):
            conv.init(g)
        for bn in (self.bn1, self.bn2, self.bn3):
            bn.init()
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                blk.init(g)
        self.attnpool.init(g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] in the compute dtype."""
        epi = epilogue(x, self.conv1, self.bn1, self.conv2, self.bn2, self.conv3, self.bn3)
        x = epi(self.conv1(x), self.bn1, relu=True)
        x = epi(self.conv2(x), self.bn2, relu=True)
        x = epi(self.conv3(x), self.bn3, relu=True, pool=True)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return self.attnpool(x)
