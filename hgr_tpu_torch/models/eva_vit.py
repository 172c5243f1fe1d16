"""EVA-02's vision transformer, the image tower of EVA02-CLIP (Sun et al.
2023, "EVA-CLIP", arXiv:2303.15389; the block of EVA-02, arXiv:2303.11331),
under EVA-CLIP's state-dict names (``github.com/baaivision/EVA``,
``EVA-CLIP/rei/eva_clip/eva_vit_model.py``, built by ``eva_clip/model.py``
from ``model_configs/EVA02-CLIP-L-14.json``).

The tower, for T = grid² + 1 tokens (row 0 the class token), every
LayerNorm with eps ``LN_EPS`` (1e-6) and no ``ln_pre``:

- ``x = [cls_token; patch_embed.proj(img)] + pos_embed``, the patch conv
  with a bias;
- each block's attention half: ``h = norm1(x)``; ``q = h Wq + q_bias``,
  ``k = h Wk`` (no bias), ``v = h Wv + v_bias`` in heads of 64; 2-D rotary
  embedding on q and k (below); ``a = softmax(q kᵀ / 8) v``; then
  ``x = x + proj(inner_attn_ln(a))`` ("subln": the LayerNorm before the
  projection);
- its MLP half ("naive SwiGLU" with subln): ``h = norm2(x)``,
  ``g = SiLU(w1 h) * (w2 h)``, ``x = x + w3(ffn_ln(g))``, ``ffn_ln`` as wide
  as the MLP (2,730 in EVA02-CLIP-L/14);
- ``feature = head(norm(x[:, 0]))``.

Rotary embedding (EVA's ``VisionRotaryEmbeddingFast`` with ``intp_freq``,
its interleaved ``rotate_half``): patch (r, c) is token ``1 + grid r + c``;
channels 0-31 of a head take the position ``p = r``, channels 32-63 take
``p = c``; the channel pair (2j, 2j+1) of a half turns by the angle
``p (ROPE_REF_GRID / grid) 10000^(-j/16)``:
``(x_2j cos - x_2j+1 sin, x_2j+1 cos + x_2j sin)``. The tables are derived,
not weights: fp32 buffers outside the state dict (a checkpoint's
``visual.rope.freqs_*`` are dropped by ``models/convert.py``), with row 0
at cos 1 and sin 0, so the class token passes unrotated; ``rope_sin``
carries ``rotate_half``'s sign (negative on even channels), so the turn is
``t * cos + swap_pairs(t) * rope_sin``.

The turn is EVA's arithmetic on both orders: q and k against the fp32
tables, each product and the sum in fp32, rounded once to the activation
dtype (EVA's ``.type_as(v)``); the signed sine changes no product's bits.

Whether autograd would record is asked once an encode
(``ops.ln_act.autograd_records``). Where it would, the blocks run plain
(``layers.attention_scores``, checkpointed under ``remat``). Where it would
not, the same ops run in a fused order: the attention is K1
(``ops.attention.attention``), ``norm1``, ``norm2``, ``inner_attn_ln`` and
``norm`` go through K3 (``ops.ln_act.add_layer_norm``) with each residual
add in the LayerNorm after it (the last block's only on the class token's
row, all ``norm`` reads), and the SwiGLU's gate with its 2,730-wide
``ffn_ln`` and the pad through K3's gate (``ops.ln_act.glu_layer_norm``;
on the plain path its twin ``layers.glu_layer_norm``, the same PyTorch
ops in the activation dtype), and the rotary of q and k in one launch
(``ops.rope.rotary``; on the plain path its twin ``layers.rotary``). Both
orders share the q/k/v product (one GEMM over the three weights, k's bias
zero) and the SwiGLU's GEMMs over the width padded to 2,736
(``SwiGLU.forward``). Each
block records ``vit.attn`` and ``vit.mlp``, as OpenAI's ViT blocks do, and
inside them ``eva.rope`` (the rotary of q and k) and ``eva.glu`` (the gate
and ``ffn_ln``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import ln_act, rope
from ..ops.attention import attention
from ..utils.profiling import annotate
from .layers import (Conv2d, LayerNorm, Linear, _param, attention_scores, glu_layer_norm, linear,
                     normal_, rotary)

ROPE_THETA = 10000.0
ROPE_REF_GRID = 16  # pt_hw_seq_len: 16 in every EVA02-CLIP config
LN_EPS = 1e-6       # the vision tower's norm_layer, partial(LayerNorm, eps=1e-6)
INIT_STD = 0.02  # EVA's trunc_normal_(std=.02), whose bounds of +-2 never bind


def rope_tables(grid: int, ref_grid: int, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, signed sin), fp32 [grid² + 1, head_dim], as the module note
    says, in EVA's fp32 arithmetic."""
    quarter = head_dim // 4
    freqs = 1.0 / ROPE_THETA ** (torch.arange(0, 2 * quarter, 2).float() / (2 * quarter))
    t = torch.arange(grid) / grid * ref_grid
    ang = (t[:, None] * freqs[None]).repeat_interleave(2, dim=-1)        # [grid, head_dim/2]
    ang = torch.cat([ang[:, None].expand(grid, grid, -1),
                     ang[None, :].expand(grid, grid, -1)], dim=-1).reshape(grid * grid, -1)
    sign = torch.tensor([-1.0, 1.0]).repeat(head_dim // 2)
    cos = torch.cat([torch.ones(1, head_dim), ang.cos()])
    sin = torch.cat([torch.zeros(1, head_dim), ang.sin() * sign])
    return cos, sin


def _merge(a: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, H Dh] (a view for K1's output)."""
    B, H, T, Dh = a.shape
    return a.transpose(1, 2).reshape(B, T, H * Dh)


class PatchEmbed(nn.Module):
    def __init__(self, width: int, patch_size: int):
        super().__init__()
        self.proj = Conv2d(3, width, patch_size, stride=patch_size, bias=True)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(width, width, bias=False)
        self.k_proj = Linear(width, width, bias=False)
        self.v_proj = Linear(width, width, bias=False)
        self.q_bias = _param(width)
        self.v_bias = _param(width)
        self.inner_attn_ln = LayerNorm(width, eps)
        self.proj = Linear(width, width)

    def qkv(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, fused: bool = False):
        """q, k (turned) and v of ``h`` [B, T, W], each [B, H, T, Dh]; the
        turn in ``layers.rotary``, or with ``fused`` in ``ops.rope.rotary``
        (the rotary kernel on CUDA), of the q and k rows as the GEMM left
        them (a row stride of 3 W)."""
        H = self.heads
        w = torch.cat((self.q_proj.weight, self.k_proj.weight, self.v_proj.weight))
        b = torch.cat((self.q_bias, torch.zeros_like(self.q_bias), self.v_bias))
        heads = linear(h, w, b).unflatten(-1, (3 * H, -1))     # [B, T, 3H, Dh]
        with annotate("eva.rope"):
            qk = (rope.rotary if fused else rotary)(heads[:, :, :2 * H], cos, sin)
        q, k = qk.transpose(1, 2).split(H, dim=1)
        return q, k, heads[:, :, 2 * H:].transpose(1, 2)


class SwiGLU(nn.Module):
    def __init__(self, width: int, hidden: int, eps: float):
        super().__init__()
        self.w1 = Linear(width, hidden)
        self.w2 = Linear(width, hidden)
        self.ffn_ln = LayerNorm(hidden, eps)
        self.w3 = Linear(hidden, width)

    def forward(self, h: torch.Tensor, fused: bool = False) -> torch.Tensor:
        """``w3(ffn_ln(SiLU(w1 h) * w2 h))``: w1 and w2 as one GEMM; the
        gate and ``ffn_ln`` (straight on the activation dtype, its
        parameters cast) in ``layers.glu_layer_norm``, or with ``fused`` in
        ``ops.ln_act.glu_layer_norm`` (K3's gate kernel on CUDA).
        The GEMMs see the width n padded with zeros to a multiple of 8
        (2,730 -> 2,736): rows of 2,730 bf16 values are not 16-byte
        aligned, and cuBLAS then leaves its Hopper kernels (on an H100 80GB
        HBM3 the two GEMMs took 213 ms a batch of 512 unpadded, 73 padded).
        The pad columns carry zeros, so they change no sum."""
        n, ln = self.w1.weight.shape[0], self.ffn_ln
        pad = -n % 8
        zw, zb = self.w1.weight.new_zeros(pad, h.shape[-1]), self.w1.bias.new_zeros(pad)
        x12 = linear(h, torch.cat((self.w1.weight, zw, self.w2.weight, zw)),
                     torch.cat((self.w1.bias, zb, self.w2.bias, zb)))
        with annotate("eva.glu"):
            g = (ln_act.glu_layer_norm(x12, ln) if fused
                 else glu_layer_norm(x12, ln.weight, ln.bias, ln.eps))
        return linear(g, F.pad(self.w3.weight, (0, pad)), self.w3.bias)


class Block(nn.Module):
    def __init__(self, width: int, heads: int, hidden: int, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(width, eps)
        self.attn = Attention(width, heads, eps)
        self.norm2 = LayerNorm(width, eps)
        self.mlp = SwiGLU(width, hidden, eps)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        a = self.attn
        with annotate("vit.attn"):
            o = _merge(attention_scores(*a.qkv(self.norm1(x), cos, sin)))
            x = x + a.proj(a.inner_attn_ln(o))
        with annotate("vit.mlp"):
            return x + self.mlp(self.norm2(x))

    def forward_fused(
        self,
        x: torch.Tensor,
        h: Optional[torch.Tensor],
        cos: torch.Tensor,
        sin: torch.Tensor,
        ln_next: LayerNorm,
        cls_only: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` with each residual add in the LayerNorm after it:
        ``h`` is ``norm1(x)`` (None: computed here), and the block returns
        its output and ``ln_next`` of it; with ``cls_only``, of the class
        token's rows alone."""
        a, add_ln = self.attn, ln_act.add_layer_norm
        with annotate("vit.attn"):
            if h is None:
                h = add_ln(x, None, self.norm1)[1]
            o = add_ln(_merge(attention(*a.qkv(h, cos, sin, fused=True))), None,
                       a.inner_attn_ln)[1]
            x, h = add_ln(x, a.proj(o), self.norm2)
        with annotate("vit.mlp"):
            out = self.mlp(h, fused=True)
            if cls_only:
                x, out = x[:, :1], out[:, :1]
            return add_ln(x, out, ln_next)


class EVAVisionTransformer(nn.Module):
    def __init__(
        self,
        input_resolution: int,
        patch_size: int,
        width: int,
        layers: int,
        heads: int,
        mlp_width: int,
        output_dim: int,
    ):
        super().__init__()
        grid = input_resolution // patch_size
        self.patch_embed = PatchEmbed(width, patch_size)
        self.cls_token = _param(1, 1, width)
        self.pos_embed = _param(1, grid * grid + 1, width)
        cos, sin = rope_tables(grid, ROPE_REF_GRID, width // heads)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.blocks = nn.ModuleList(Block(width, heads, mlp_width, LN_EPS)
                                    for _ in range(layers))
        self.norm = LayerNorm(width, LN_EPS)
        self.head = Linear(width, output_dim)

    def init(self, g: torch.Generator) -> None:
        """EVA's initialisation: normal 0.02 for the class token, positions,
        every linear weight and the head, zero biases, LayerNorms at one and
        zero, the patch conv as ``Conv2d.init`` (PyTorch's default bound);
        block i's ``attn.proj`` and ``mlp.w3`` weights then divided by
        ``sqrt(2 (i + 1))`` (``fix_init_weight``)."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.init(g, INIT_STD)
            elif isinstance(m, LayerNorm):
                m.init()
        normal_(self.cls_token, INIT_STD, g)
        normal_(self.pos_embed, INIT_STD, g)
        self.patch_embed.proj.init(g)
        with torch.no_grad():
            for i, blk in enumerate(self.blocks):
                blk.attn.q_bias.zero_()
                blk.attn.v_bias.zero_()
                blk.attn.proj.weight.div_((2.0 * (i + 1)) ** 0.5)
                blk.mlp.w3.weight.div_((2.0 * (i + 1)) ** 0.5)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: [B, 3, H, W] in the compute dtype -> [B, output_dim]."""
        x = self.patch_embed.proj(x)                       # [B, width, g, g]
        B, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)                   # [B, g*g, width]
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, width), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        cos, sin = self.rope_cos, self.rope_sin
        if ln_act.autograd_records(x, self):
            for blk in self.blocks:
                x = (checkpoint(blk, x, cos, sin, use_reentrant=False) if remat
                     else blk(x, cos, sin))
            return self.head(self.norm(x[:, :1])[:, 0])
        blocks, h = self.blocks, None
        for i, blk in enumerate(blocks[:-1]):
            x, h = blk.forward_fused(x, h, cos, sin, blocks[i + 1].norm1)
        _, h = blocks[-1].forward_fused(x, h, cos, sin, self.norm, cls_only=True)
        return self.head(h[:, 0])
