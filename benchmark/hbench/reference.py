"""Plain CLIP in PyTorch: the reference every cell's output is judged by.

OpenAI's CLIP (``github.com/openai/CLIP``, ``clip/model.py``): the modified
ResNet with its attention pool, the ViT, and the causal text transformer
with EOT pooling, written from the published description in float32 (TF32
off), with no kernels, caches or fused steps. It imports nothing of the
program. The weights are a state dict under OpenAI's names, which the
benchmark draws (:func:`draw_weights`) and hands to both sides.

The harness reaches these functions through ``benchmark/families/clip.py``,
the family of every configuration that names none (``hbench/family.py``).
``tests/test_torch_models.py`` loads this file by its path, on its own,
and calls :func:`param_spec`, :func:`encode_image` and
:func:`encode_text` on the configuration layout it reads here: a change to
any of them has to update that test too, and the file takes no new
top-level relative import.

``quant`` replaces the input of every matrix product and convolution by
its image in a lower precision: the control, the reference put in the
program's place one precision step below the configuration's bf16
(float8 e4m3 with a per-tensor scale, products accumulated in float32).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
EXPANSION = 4
CALIBRATION_IMAGES = 64

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in fp32;
    gradients pass through it unrounded (as fp8 training keeps its
    gradients in a wider type)."""
    d = x.detach().float()
    s = d.abs().amax().clamp_min(1e-30) / 448.0
    q = (d / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - d) if x.requires_grad else q


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


# ---------------------------------------------------------------------------
# parameters: OpenAI's names and shapes, and how the benchmark draws them
# ---------------------------------------------------------------------------


def param_spec(cfg: Dict) -> "OrderedDict[str, Tuple[Tuple[int, ...], str, float]]":
    """name -> (shape, kind, scale). Kinds: ``normal`` (std ``scale``),
    ``affine_w``/``affine_b`` (LayerNorm and BatchNorm scale and shift near
    1 and 0), ``bn_mean``, ``bn_var`` and ``const``."""
    spec: "OrderedDict[str, Tuple[Tuple[int, ...], str, float]]" = OrderedDict()

    def conv(name, cout, cin, k):
        spec[name] = ((cout, cin, k, k), "normal", math.sqrt(2.0 / (cin * k * k)))

    def bn(name, c, gain=1.0):
        spec[name + ".weight"] = ((c,), "affine_w", gain)
        spec[name + ".bias"] = ((c,), "affine_b", 0.1)
        spec[name + ".running_mean"] = ((c,), "bn_mean", 0.1)
        spec[name + ".running_var"] = ((c,), "bn_var", 0.2)

    def ln(name, c):
        spec[name + ".weight"] = ((c,), "affine_w", 1.0)
        spec[name + ".bias"] = ((c,), "affine_b", 0.05)

    def lin(name, dout, din, std):
        spec[name + ".weight"] = ((dout, din), "normal", std)
        spec[name + ".bias"] = ((dout,), "normal", 0.02)

    def blocks(prefix, width, layers):
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            spec[p + ".attn.in_proj_weight"] = ((3 * width, width), "normal", width ** -0.5)
            spec[p + ".attn.in_proj_bias"] = ((3 * width,), "normal", 0.02)
            lin(p + ".attn.out_proj", width, width, proj_std)
            ln(p + ".ln_1", width)
            lin(p + ".mlp.c_fc", 4 * width, width, (2 * width) ** -0.5)
            lin(p + ".mlp.c_proj", width, 4 * width, proj_std)
            ln(p + ".ln_2", width)

    v = cfg["vision"]
    embed = cfg["embed_dim"]
    if v["patch_size"]:
        w, ps, res = v["width"], v["patch_size"], v["image_resolution"]
        spec["visual.conv1.weight"] = ((w, 3, ps, ps), "normal", w ** -0.5)
        spec["visual.class_embedding"] = ((w,), "normal", w ** -0.5)
        spec["visual.positional_embedding"] = (((res // ps) ** 2 + 1, w), "normal", w ** -0.5)
        ln("visual.ln_pre", w)
        blocks("visual.transformer", w, v["layers"])
        ln("visual.ln_post", w)
        spec["visual.proj"] = ((w, embed), "normal", w ** -0.5)
    else:
        w = v["width"]
        conv("visual.conv1.weight", w // 2, 3, 3)
        bn("visual.bn1", w // 2)
        conv("visual.conv2.weight", w // 2, w // 2, 3)
        bn("visual.bn2", w // 2)
        conv("visual.conv3.weight", w, w // 2, 3)
        bn("visual.bn3", w)
        inplanes = w
        for li, (n, planes) in enumerate(zip(v["layers"], [w, 2 * w, 4 * w, 8 * w]), 1):
            for b in range(n):
                stride = 2 if (li > 1 and b == 0) else 1
                p = f"visual.layer{li}.{b}"
                conv(p + ".conv1.weight", planes, inplanes, 1)
                bn(p + ".bn1", planes)
                conv(p + ".conv2.weight", planes, planes, 3)
                bn(p + ".bn2", planes)
                conv(p + ".conv3.weight", planes * EXPANSION, planes, 1)
                bn(p + ".bn3", planes * EXPANSION, gain=0.5)
                if stride > 1 or inplanes != planes * EXPANSION:
                    conv(p + ".downsample.0.weight", planes * EXPANSION, inplanes, 1)
                    bn(p + ".downsample.1", planes * EXPANSION)
                inplanes = planes * EXPANSION
        c = w * 32
        grid = v["image_resolution"] // 32
        spec["visual.attnpool.positional_embedding"] = ((grid * grid + 1, c), "normal", c ** -0.5)
        for n in ("k_proj", "q_proj", "v_proj"):
            lin(f"visual.attnpool.{n}", c, c, c ** -0.5)
        lin("visual.attnpool.c_proj", embed, c, c ** -0.5)

    t = cfg["text"]
    tw = t["width"]
    blocks("transformer", tw, t["layers"])
    spec["token_embedding.weight"] = ((t["vocab_size"], tw), "normal", 0.02)
    spec["positional_embedding"] = ((t["context_length"], tw), "normal", 0.01)
    ln("ln_final", tw)
    spec["text_projection"] = ((tw, embed), "normal", tw ** -0.5)
    spec["logit_scale"] = ((), "const", math.log(1 / 0.07))
    return spec


@torch.no_grad()
def draw_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 on ``device``, from one draw of a
    ``torch.Generator`` on that device (the master type the program keeps)."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for shape, _, _ in spec.values()]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, (shape, kind, scale)), n in zip(spec.items(), sizes):
        z = flat[off: off + n].view(shape)
        off += n
        if kind == "normal":
            t = z * scale
        elif kind == "affine_w":
            t = scale * (1.0 + 0.1 * z)
        elif kind in ("affine_b", "bn_mean"):
            t = z * scale
        elif kind == "bn_var":
            t = torch.exp(z * scale)
        else:  # const
            t = torch.full(shape, scale, device=device)
        out[name] = t.contiguous()
    if not cfg["vision"]["patch_size"]:
        calibrate_batchnorm(out, cfg, seed, device)
    return out


def calibrate_batchnorm(sd: Dict[str, torch.Tensor], cfg: Dict, seed: int, device) -> None:
    """Set the ResNet's running statistics to those of a seeded batch of
    images, layer by layer, as a trained network's BatchNorm holds its
    data's, then centre the tower's output on that batch through the last
    projection's bias. Without it, random statistics leave the features
    of all images nearly parallel, and an image's part in a batch nearly
    invisible."""
    from .inputs import images

    set_fp32(device)
    res = cfg["vision"]["image_resolution"]
    x = _pixels(torch.as_tensor(images(CALIBRATION_IMAGES, res, seed, 99, device), device=device))
    _resnet(x, sd, cfg, None, calibrate=True)
    sd["visual.attnpool.c_proj.bias"] = sd["visual.attnpool.c_proj.bias"] - \
        _resnet(x, sd, cfg, None).mean(dim=0)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _linear(x, sd, name, quant: Quant, bias=True):
    w = sd[name + ".weight"]
    return F.linear(_q(quant, x), _q(quant, w), sd[name + ".bias"] if bias else None)


def _ln(x, sd, name):
    return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], 1e-5)


def _attend(q, k, v, heads: int, mask, quant: Quant):
    """[B, Tq, D], [B, T, D] -> softmax(q k^T / sqrt(Dh) + mask) v, [B, Tq, D]."""
    B, Tq, D = q.shape
    T = k.shape[1]
    dh = D // heads
    qh = q.view(B, Tq, heads, dh).transpose(1, 2)
    kh = k.view(B, T, heads, dh).transpose(1, 2)
    vh = v.view(B, T, heads, dh).transpose(1, 2)
    s = torch.matmul(_q(quant, qh), _q(quant, kh).transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(_q(quant, p), _q(quant, vh))
    return o.transpose(1, 2).reshape(B, Tq, D)


def transformer(x, sd, prefix: str, layers: int, heads: int, mask, quant: Quant):
    D = x.shape[-1]
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        h = _ln(x, sd, p + ".ln_1")
        qkv = F.linear(_q(quant, h), _q(quant, sd[p + ".attn.in_proj_weight"]),
                       sd[p + ".attn.in_proj_bias"])
        q, k, v = qkv.split(D, dim=-1)
        x = x + _linear(_attend(q, k, v, heads, mask, quant), sd, p + ".attn.out_proj", quant)
        h = _linear(_ln(x, sd, p + ".ln_2"), sd, p + ".mlp.c_fc", quant)
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        x = x + _linear(h, sd, p + ".mlp.c_proj", quant)
    return x


def encode_text(sd, cfg: Dict, tokens: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[N, T] ids -> [N, embed] features, unnormalised (``encode_text``)."""
    t = cfg["text"]
    T = tokens.shape[1]
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"][:T]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu_(1)
    x = transformer(x, sd, "transformer", t["layers"], t["heads"], mask, quant)
    x = _ln(x, sd, "ln_final")
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return torch.matmul(_q(quant, x), _q(quant, sd["text_projection"]))


def _bn(x, sd, name):
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    m, v = sd[name + ".running_mean"], sd[name + ".running_var"]
    return (x - m[:, None, None]) / torch.sqrt(v[:, None, None] + 1e-5) * w[:, None, None] \
        + b[:, None, None]


def _conv(x, sd, name, quant: Quant, stride=1, padding=0):
    return F.conv2d(_q(quant, x), _q(quant, sd[name]), stride=stride, padding=padding)


def _resnet(x, sd, cfg: Dict, quant: Quant, calibrate: bool = False):
    """The modified ResNet; with ``calibrate`` each BatchNorm first takes
    the batch's per-channel mean and variance as its running statistics."""
    v = cfg["vision"]

    def bn(x, name):
        if calibrate:
            sd[name + ".running_mean"] = x.mean(dim=(0, 2, 3))
            sd[name + ".running_var"] = x.var(dim=(0, 2, 3), unbiased=False)
        return _bn(x, sd, name)

    x = F.relu(bn(_conv(x, sd, "visual.conv1.weight", quant, 2, 1), "visual.bn1"))
    x = F.relu(bn(_conv(x, sd, "visual.conv2.weight", quant, 1, 1), "visual.bn2"))
    x = F.relu(bn(_conv(x, sd, "visual.conv3.weight", quant, 1, 1), "visual.bn3"))
    x = F.avg_pool2d(x, 2)
    for li, n in enumerate(v["layers"], 1):
        for b in range(n):
            p = f"visual.layer{li}.{b}"
            stride = 2 if (li > 1 and b == 0) else 1
            out = F.relu(bn(_conv(x, sd, p + ".conv1.weight", quant), p + ".bn1"))
            out = F.relu(bn(_conv(out, sd, p + ".conv2.weight", quant, 1, 1), p + ".bn2"))
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out = bn(_conv(out, sd, p + ".conv3.weight", quant), p + ".bn3")
            idn = x
            if p + ".downsample.0.weight" in sd:
                idn = F.avg_pool2d(x, stride) if stride > 1 else x
                idn = bn(_conv(idn, sd, p + ".downsample.0.weight", quant), p + ".downsample.1")
            x = F.relu(out + idn)
    # attention pool: the mean token's query over all tokens
    B, C = x.shape[:2]
    tok = x.flatten(2).transpose(1, 2)
    tok = torch.cat([tok.mean(dim=1, keepdim=True), tok], dim=1)
    tok = tok + sd["visual.attnpool.positional_embedding"]
    q = _linear(tok[:, :1], sd, "visual.attnpool.q_proj", quant)
    k = _linear(tok, sd, "visual.attnpool.k_proj", quant)
    val = _linear(tok, sd, "visual.attnpool.v_proj", quant)
    heads = v["width"] * 32 // 64
    o = _attend(q, k, val, heads, None, quant)
    return _linear(o, sd, "visual.attnpool.c_proj", quant)[:, 0]


def _vit(x, sd, cfg: Dict, quant: Quant):
    v = cfg["vision"]
    x = _conv(x, sd, "visual.conv1.weight", quant, stride=v["patch_size"])
    B, W = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["visual.class_embedding"].expand(B, 1, W), x], dim=1)
    x = x + sd["visual.positional_embedding"]
    x = _ln(x, sd, "visual.ln_pre")
    x = transformer(x, sd, "visual.transformer", v["layers"], v["width"] // 64, None, quant)
    x = _ln(x[:, 0], sd, "visual.ln_post")
    return torch.matmul(_q(quant, x), _q(quant, sd["visual.proj"]))


def _pixels(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, 3, H, W] float32: ToTensor and Normalize
    with CLIP's mean and std."""
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    return ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()


def encode_image(sd, cfg: Dict, images: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, embed] features, unnormalised."""
    x = _pixels(images)
    if cfg["vision"]["patch_size"]:
        return _vit(x, sd, cfg, quant)
    return _resnet(x, sd, cfg, quant)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def set_fp32(device) -> None:
    """float32 means float32: no TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
