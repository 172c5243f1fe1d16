"""The work a cell's inputs need, under CLIP's published arithmetic.

Counts are of what the inputs need, never of the shapes the program pads
to: a prompt runs through its EOT token, causal attention covers its live
``L(L+1)/2`` entries, the class head covers the real classes, and
attention moves q, k, v and o once. A multiply-add is two operations.
Elementwise work (norms, activations, softmax) is not counted, as MFU
conventionally leaves it out. A later program that pads less then shows as
a higher share, not as a stale count.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16, NVIDIA's data sheet (700 W)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
BF16_BYTES = 2


def resnet_image_flops(cfg: Dict) -> float:
    """Operations of the modified ResNet for one image: convolutions, the
    attention pool's projections and its one query's attention."""
    v = cfg["vision"]
    w, res = v["width"], v["image_resolution"]

    def conv(cin, cout, k, hw):
        return 2.0 * cin * cout * k * k * hw * hw

    h = res // 2
    f = conv(3, w // 2, 3, h) + conv(w // 2, w // 2, 3, h) + conv(w // 2, w, 3, h)
    h //= 2
    inplanes = w
    for li, (n, planes) in enumerate(zip(v["layers"], [w, 2 * w, 4 * w, 8 * w]), 1):
        for b in range(n):
            stride = 2 if (li > 1 and b == 0) else 1
            ho = h // stride
            f += conv(inplanes, planes, 1, h) + conv(planes, planes, 3, h)
            f += conv(planes, 4 * planes, 1, ho)
            if stride > 1 or inplanes != 4 * planes:
                f += conv(inplanes, 4 * planes, 1, ho)
            inplanes, h = 4 * planes, ho
    c, t = inplanes, h * h + 1
    f += 2.0 * t * c * c * 2 + 2.0 * c * c          # k, v over all tokens; q of one
    f += 2.0 * 2 * t * c                             # q.k and p.v of one query
    f += 2.0 * c * cfg["embed_dim"]
    return f


def transformer_flops(tokens: float, width: int, attn_entries: float) -> float:
    """One block: projections and MLP over ``tokens``, attention over
    ``attn_entries`` (query, key) pairs."""
    return 24.0 * tokens * width * width + 4.0 * attn_entries * width


def vit_image_flops(cfg: Dict) -> float:
    v = cfg["vision"]
    w, ps, res = v["width"], v["patch_size"], v["image_resolution"]
    n = (res // ps) ** 2
    t = n + 1
    f = 2.0 * 3 * ps * ps * w * n
    f += v["layers"] * transformer_flops(t, w, t * t)
    return f + 2.0 * w * cfg["embed_dim"]


def image_flops(cfg: Dict) -> float:
    if cfg["vision"]["patch_size"]:
        return vit_image_flops(cfg)
    return resnet_image_flops(cfg)


def text_flops(cfg: Dict, lengths: Sequence[int]) -> float:
    """The text tower over prompts of these lengths (through EOT), causal."""
    t = cfg["text"]
    L = np.asarray(lengths, dtype=np.float64)
    per_layer = transformer_flops(L.sum(), t["width"], (L * (L + 1) / 2).sum())
    return t["layers"] * per_layer + 2.0 * t["width"] * cfg["embed_dim"] * len(L)


def head_flops(cfg: Dict, images: int, classes: int) -> float:
    """Cosine logits of ``images`` against ``classes`` bank rows."""
    return 2.0 * images * classes * cfg["embed_dim"]


def text_attention_work(cfg: Dict, lengths: Sequence[int]) -> Dict[str, float]:
    """K1 in one bank build: operations and bytes over all layers."""
    t = cfg["text"]
    L = np.asarray(lengths, dtype=np.float64)
    flops = 4.0 * t["width"] * (L * (L + 1) / 2).sum() * t["layers"]
    nbytes = 4.0 * L.sum() * t["width"] * BF16_BYTES * t["layers"]
    return {"flops": flops, "bytes": nbytes}


def vit_attention_work(cfg: Dict, images: int) -> Dict[str, float]:
    """K1 in the ViT tower over ``images`` images: every layer, no mask."""
    v = cfg["vision"]
    t = (v["image_resolution"] // v["patch_size"]) ** 2 + 1
    flops = 4.0 * v["width"] * t * t * v["layers"] * images
    nbytes = 4.0 * t * v["width"] * BF16_BYTES * v["layers"] * images
    return {"flops": flops, "bytes": nbytes}


def bound_s(work: Dict[str, float]) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(work["flops"] / PEAK_BF16_FLOPS, work["bytes"] / PEAK_HBM_BYTES)
