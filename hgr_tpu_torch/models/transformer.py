"""Pre-LN residual transformer stack shared by the text tower and the ViT
(port of ``hgr_tpu/models/transformer.py``).

Behaviour of the reference's ``Transformer`` / ``ResidualAttentionBlock``
(``clip/model.py:153-199``): QuickGELU MLP, packed-QKV attention, optional
causal mask, and the reference's init scheme (``clip/model.py:302-315``).
The JAX package stacks the blocks for ``lax.scan``; here they are a
``ModuleList`` run by a Python loop, under the OpenAI names
``resblocks.{i}.attn.in_proj_weight`` and so on.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import annotate
from .layers import LayerNorm, Linear, _param, mha, normal_, quick_gelu


class MultiheadAttention(nn.Module):
    """Packed-QKV parameters in ``nn.MultiheadAttention``'s layout."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = _param(3 * width, width)
        self.in_proj_bias = _param(3 * width)
        self.out_proj = Linear(width, width)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    """With ``span``, the attention half records the span ``{span}.attn``
    and the MLP half ``{span}.mlp`` (``utils/profiling.annotate``)."""

    def __init__(self, width: int, heads: int, span: Optional[str] = None):
        super().__init__()
        self.heads = heads
        self.spans = (f"{span}.attn", f"{span}.mlp") if span else None
        self.attn = MultiheadAttention(width)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNorm(width)

    def init(self, g: torch.Generator, layers: int) -> None:
        """``block_init``: attention std ``w^-0.5``, projections
        ``w^-0.5 (2L)^-0.5``, MLP input ``(2w)^-0.5``, zero biases."""
        width = self.ln_1.weight.shape[0]
        proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
        normal_(self.attn.in_proj_weight, width ** -0.5, g)
        nn.init.zeros_(self.attn.in_proj_bias)
        self.attn.out_proj.init(g, proj_std)
        self.mlp.c_fc.init(g, (2 * width) ** -0.5)
        self.mlp.c_proj.init(g, proj_std)
        self.ln_1.init()
        self.ln_2.init()

    def _span(self, i: int):
        return annotate(self.spans[i]) if self.spans else contextlib.nullcontext()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], attn_fn) -> torch.Tensor:
        a = self.attn
        with self._span(0):
            x = x + mha(
                self.ln_1(x), a.in_proj_weight, a.in_proj_bias,
                a.out_proj.weight, a.out_proj.bias, self.heads, mask, attn_fn,
            )
        with self._span(1):
            return x + self.mlp.c_proj(quick_gelu(self.mlp.c_fc(self.ln_2(x))))


class Transformer(nn.Module):
    """``span`` names the spans each block records (``ResidualAttentionBlock``);
    None records none."""

    def __init__(self, width: int, layers: int, heads: int, span: Optional[str] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, span) for _ in range(layers)
        )

    def init(self, g: torch.Generator) -> None:
        for blk in self.resblocks:
            blk.init(g, len(self.resblocks))

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor], attn_fn, remat: bool = False
    ) -> torch.Tensor:
        """``remat=True`` checkpoints each block, so the backward pass
        recomputes its activations (``jax.checkpoint`` of the block body,
        ``hgr_tpu/models/transformer.py:104-107``)."""
        for blk in self.resblocks:
            if remat:
                x = checkpoint(blk, x, mask, attn_fn, use_reentrant=False)
            else:
                x = blk(x, mask, attn_fn)
        return x
