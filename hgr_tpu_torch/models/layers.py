"""Building blocks shared by the CLIP encoders (port of
``hgr_tpu/models/layers.py``).

Two kinds of thing live here:

- functions over tensors with the JAX package's numerics: master parameters
  stay fp32 and are cast to the activation dtype at use; LayerNorm and the
  attention softmax run in fp32 and return the input dtype; BatchNorm is
  frozen-stats and folded into one multiply-add in the same operation order
  (``batch_norm_act`` adds the ResNet's epilogue: the plain twin of the
  fused kernel in ``ops/bn_act.py``);
- parameter holders (``Linear``, ``LayerNorm``, ``Conv2d``, ``BatchNorm2d``,
  ``Embedding``) whose ``state_dict`` keys are the OpenAI CLIP names
  (``weight``, ``bias``, ``running_mean``, ``running_var``). They allocate
  uninitialised storage and draw nothing: every random value comes from an
  explicit ``torch.Generator`` in ``init`` (see ``models/clip.py``).

Layouts are torch's (linear ``[out, in]``, conv ``OIHW``, images ``NCHW``
inside the image tower); ``models/convert.py`` maps the JAX layouts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w.T + b`` in ``x``'s dtype (``w`` is ``[out, in]``)."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """fp32-internal LayerNorm (bf16-safe), output in the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def glu_layer_norm(
    x12: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float
) -> torch.Tensor:
    """EVA-02's SwiGLU gate and ``ffn_ln`` on its w1/w2 GEMM's output padded
    to np columns a half (n = ``w``'s width rounded up to a multiple of 8):
    x1 is ``x12``'s columns [0, n), x2 its [np, np + n). Returns
    ``LayerNorm(SiLU(x1) * x2)`` over the n columns, straight on the
    activation dtype with ``w`` and ``b`` cast to it, then np - n zero
    columns: ``[..., np]``, the padded input of ``w3``."""
    n, np_ = w.shape[0], x12.shape[-1] // 2
    g = F.silu(x12[..., :n]) * x12[..., np_: np_ + n]
    g = F.layer_norm(g, (n,), w.to(g.dtype), b.to(g.dtype), eps)
    return F.pad(g, (0, np_ - n))


def swap_pairs(t: torch.Tensor) -> torch.Tensor:
    """``t`` with the channels of each pair (2j, 2j+1) of its last dim
    swapped."""
    return t.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)


def rotary(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """EVA-02's rotary turn of ``t`` [..., T, R, Dh] (R rows a position,
    e.g. the q and k heads): ``t * cos + swap_pairs(t) * sin`` with the fp32
    tables [T, Dh] (``sin`` carrying ``rotate_half``'s sign), in fp32,
    rounded once to ``t``'s dtype: the twin of the kernel in
    ``ops/rope.py``."""
    return (t.float() * cos[:, None] + swap_pairs(t).float() * sin[:, None]).to(t.dtype)


def conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
    b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inference-mode BN on NCHW folded into one multiply-add; the fold is
    computed in fp32 and cast, as ``hgr_tpu/models/layers.py:114-117``."""
    inv, shift = _fold(scale, bias, mean, var, x.dtype, eps)
    return x * inv + shift


def _fold(scale, bias, mean, var, dtype: torch.dtype, eps: float = 1e-5):
    """``batch_norm``'s fold: (inv, shift) rounded to ``dtype``, each
    ``[C, 1, 1]``."""
    inv = torch.rsqrt(var + eps) * scale
    shift = bias - mean * inv
    return inv.to(dtype)[:, None, None], shift.to(dtype)[:, None, None]


def batch_norm_act(
    x: torch.Tensor,
    bn: Optional["BatchNorm2d"],
    residual: Optional[torch.Tensor] = None,
    residual_bn: Optional["BatchNorm2d"] = None,
    relu: bool = False,
    pool: bool = False,
) -> torch.Tensor:
    """Frozen BatchNorm and the ResNet's epilogue on NCHW: ``bn`` (none: the
    identity), plus ``residual`` (itself through ``residual_bn`` where
    given), then ReLU, then the 2x2 mean, each a PyTorch op in that order.
    The plain twin of the fused kernel in ``ops/bn_act.py``."""
    if bn is not None:
        x = batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if residual is not None:
        if residual_bn is not None:
            residual = batch_norm(residual, residual_bn.weight, residual_bn.bias,
                                  residual_bn.running_mean, residual_bn.running_var)
        x = x + residual
    if relu:
        x = F.relu(x)
    return F.avg_pool2d(x, 2) if pool else x


def _fold_grads(bn, sum_g: torch.Tensor, sum_gy: torch.Tensor, eps: float = 1e-5):
    """The fp32 gradients of ``bn``'s weight, bias, running_mean and
    running_var, given the per-channel sums of the gradient at the folded
    multiply-add's output (``sum_g``, the shift's gradient) and of that
    gradient times its input (``sum_gy``, the scale's), through
    ``inv = rsqrt(var + eps) * weight`` and ``shift = bias - mean * inv``."""
    rs = torch.rsqrt(bn.running_var + eps)
    d_inv = sum_gy - sum_g * bn.running_mean
    return [d_inv * rs, sum_g, -(sum_g * (rs * bn.weight)),
            d_inv * bn.weight * (-0.5 * rs * rs * rs)]


def batch_norm_act_backward(
    g: torch.Tensor,
    x: torch.Tensor,
    bn: Optional["BatchNorm2d"],
    residual: Optional[torch.Tensor] = None,
    residual_bn: Optional["BatchNorm2d"] = None,
    relu: bool = False,
    pool: bool = False,
):
    """The gradients of ``batch_norm_act(x, bn, residual, residual_bn, relu,
    pool)`` given ``g``, the gradient of its output, as the backward kernel
    in ``ops/bn_act.py`` computes them; its plain twin. The pool spreads
    each ``g / 4`` over its 2x2 window (an odd last row or column gets 0);
    the ReLU passes it where the pre-activation, recomputed from ``x`` and
    ``residual`` with the forward's arithmetic, is not ``<= 0``: ``g_m``.
    ``dx = g_m * inv`` and ``dres = g_m`` (``g_m * rinv`` through
    ``residual_bn``) in ``x``'s dtype; each BatchNorm's four parameter
    gradients in fp32 through its fold, from fp32 per-channel sums of
    ``g_m``, ``g_m * x`` and ``g_m * residual``. Returns ``(dx, dres,
    bn_grads, residual_bn_grads)``, each None where there is no such
    input, a BatchNorm's as ``[weight, bias, running_mean, running_var]``."""
    if pool:
        H, W = x.shape[2:]
        g = (g * 0.25).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        g = F.pad(g, (0, W % 2, 0, H % 2))
    y = x
    if bn is not None:
        inv, shift = _fold(bn.weight, bn.bias, bn.running_mean, bn.running_var, x.dtype)
        y = x * inv + shift
    r = residual
    if residual_bn is not None:
        rinv, rshift = _fold(residual_bn.weight, residual_bn.bias, residual_bn.running_mean,
                             residual_bn.running_var, x.dtype)
        r = residual * rinv + rshift
    if residual is not None:
        y = y + r
    g_m = torch.where(y <= 0, 0, g) if relu else g
    sum_g = g_m.float().sum((0, 2, 3))
    bn_grads = rbn_grads = dres = None
    dx = g_m
    if bn is not None:
        dx = g_m * inv
        bn_grads = _fold_grads(bn, sum_g, (g_m.float() * x.float()).sum((0, 2, 3)))
    if residual is not None:
        dres = g_m
        if residual_bn is not None:
            dres = g_m * rinv
            rbn_grads = _fold_grads(residual_bn, sum_g,
                                    (g_m.float() * residual.float()).sum((0, 2, 3)))
    return dx, dres, bn_grads, rbn_grads


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain scaled-dot-product attention over ``[B, H, T, Dh]``: the twin of
    the fused kernel in ``ops/attention.py``.

    Scores in fp32, additive fp32 ``[Tq, Tk]`` mask, fp32 softmax, then the
    probabilities cast to ``v``'s dtype and contracted with ``v``.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def mha(
    x: torch.Tensor,
    in_proj_weight: torch.Tensor,
    in_proj_bias: torch.Tensor,
    out_weight: torch.Tensor,
    out_bias: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor],
    attn_fn,
) -> torch.Tensor:
    """Packed-QKV self-attention on ``[B, T, D]``.

    q, k and v reach ``attn_fn`` as strided ``[B, H, T, Dh]`` views of the
    packed ``[B, T, 3D]`` projection, and its output is read back through a
    view: the fused kernel takes strides, so no head transpose is copied.
    """
    B, T, D = x.shape
    qkv = linear(x, in_proj_weight, in_proj_bias)  # [B, T, 3D]

    def heads(t):
        return t.view(B, T, num_heads, D // num_heads).transpose(1, 2)

    q, k, v = qkv.split(D, dim=-1)
    out = attn_fn(heads(q), heads(k), heads(v), mask)  # [B, H, T, Dh]
    out = out.transpose(1, 2).reshape(B, T, D)
    return linear(out, out_weight, out_bias)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive causal mask, ``0`` on/below the diagonal, ``-inf`` above
    (reference ``clip/model.py:324-330``)."""
    m = torch.full((T, T), float("-inf"), dtype=torch.float32, device=device)
    return torch.triu(m, diagonal=1)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=dim, keepdim=True))
    return (xf / torch.clamp_min(n, eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# parameter holders (OpenAI CLIP state_dict names; no random draws)
# ---------------------------------------------------------------------------


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g) * std)


class Linear(nn.Module):
    """``bias=False`` holds no bias (EVA-02's q, k and v projections)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = _param(d_out, d_in)
        self.bias = _param(d_out) if bias else None

    def init(self, g: torch.Generator, std: Optional[float] = None) -> None:
        """Normal weights (std ``d_in ** -0.5`` by default), zero bias
        (``linear_init``)."""
        normal_(self.weight, self.weight.shape[1] ** -0.5 if std is None else std, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """``eps`` is a constant of the architecture (1e-5 in OpenAI's CLIP,
    1e-6 in EVA-02's image tower), not a weight: ``ops.ln_act`` reads it."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.eps = eps

    def init(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Module):
    """Bias-free by default (CLIP's convs have none); ``bias=True`` adds one
    (EVA-02's patch embedding), zero after ``init``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = False):
        super().__init__()
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None
        self.stride, self.padding = stride, padding

    def init(self, g: torch.Generator) -> None:
        """He-uniform fan-in bound ``sqrt(1 / fan_in)`` (``conv_init``)."""
        cout, cin, kh, kw = self.weight.shape
        bound = math.sqrt(1.0 / (kh * kw * cin))
        with torch.no_grad():
            self.weight.copy_(
                (torch.rand(self.weight.shape, generator=g) * 2 - 1) * bound
            )
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.stride, self.padding, self.bias)


class BatchNorm2d(nn.Module):
    """Frozen-stats BN: affine parameters plus running statistics, applied
    by ``batch_norm_act`` (or its kernel, ``ops/bn_act.py``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.register_buffer("running_mean", torch.empty(dim))
        self.register_buffer("running_var", torch.empty(dim))

    def init(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = _param(n, dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)
