"""Pre-LN residual transformer stack shared by the text tower and the ViT
(port of ``hgr_tpu/models/transformer.py``).

Behaviour of the reference's ``Transformer`` / ``ResidualAttentionBlock``
(``clip/model.py:153-199``): QuickGELU MLP, packed-QKV attention, optional
causal mask, and the reference's init scheme (``clip/model.py:302-315``).
The MLP's ``activation`` may instead be ``"gelu"``, exact GELU: EVA-CLIP's
text tower (``eva_clip/model.py`` builds ``nn.GELU`` where the model config
has no ``quick_gelu`` key), or ``"gelu_tanh"``, GELU's tanh form in one
PyTorch op (SigLIP's ``gelu_pytorch_tanh``, both towers); its width
``mlp_width`` (4 x width by default, SigLIP's 4,304) and the LayerNorms'
``eps`` (SigLIP's 1e-6) are the architecture's.
The JAX package stacks the blocks for ``lax.scan``; here they are a
``ModuleList`` run by a Python loop, under the OpenAI names
``resblocks.{i}.attn.in_proj_weight`` and so on.

The stack runs hand kernels or their plain twins as its tower says: the
ViT, the text encoder and CoOp's text path each ask
``ops.ln_act.autograd_records`` once an encode (gradients on, and the input
or a parameter requires one) and pass the answer; their own callers pass
nothing. Where autograd would record, the blocks run plain:
``layers.attention_scores``, the plain add, LayerNorm and QuickGELU, under
``remat`` checkpointed. Where it would record nothing (``remat`` then has nothing to recompute), the same ops run in a
fused order: the attention is ``ops.attention.attention`` (K1), each
residual add goes into the LayerNorm that follows it
(``ops.ln_act.add_layer_norm``: the attention half's into ``ln_2``, the MLP
half's into the next block's ``ln_1`` or into ``ln_final``), and QuickGELU
is ``ops.ln_act.quick_gelu`` (K3); the GELUs are PyTorch's op on both
paths. On CUDA those are the kernels; on the
CPU, the plain twins, which give the plain block's result bit for bit. A
check that holds the kernels' path to the plain attention substitutes
``attention_scores`` for this module's name ``attention``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import ln_act
from ..ops.attention import attention
from ..utils.profiling import annotate
from .layers import LayerNorm, Linear, _param, attention_scores, mha, normal_, quick_gelu


class MultiheadAttention(nn.Module):
    """Packed-QKV parameters in ``nn.MultiheadAttention``'s layout."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = _param(3 * width, width)
        self.in_proj_bias = _param(3 * width)
        self.out_proj = Linear(width, width)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int = 0):
        super().__init__()
        hidden = hidden or 4 * width
        self.c_fc = Linear(width, hidden)
        self.c_proj = Linear(hidden, width)


ACTIVATIONS = ("quick_gelu", "gelu", "gelu_tanh")


def activate(h: torch.Tensor, activation: str, fused: bool = False) -> torch.Tensor:
    """The MLP's activation: QuickGELU (K3's ``quick_gelu`` where ``fused``,
    its twin otherwise), exact GELU or GELU's tanh form."""
    if activation == "gelu":
        return F.gelu(h)
    if activation == "gelu_tanh":
        return F.gelu(h, approximate="tanh")
    return ln_act.quick_gelu(h) if fused else quick_gelu(h)


class ResidualAttentionBlock(nn.Module):
    """With ``span``, the attention half records the span ``{span}.attn``
    and the MLP half ``{span}.mlp`` (``utils/profiling.annotate``); in
    ``forward_fused`` the attention half's span holds its add (in ``ln_2``)
    and the MLP half's span holds the MLP's add (in the next LayerNorm).
    ``activation`` is one of ``ACTIVATIONS`` (QuickGELU is K3's
    ``quick_gelu`` in the fused order)."""

    def __init__(self, width: int, heads: int, span: Optional[str] = None,
                 activation: str = "quick_gelu", mlp_width: int = 0, eps: float = 1e-5):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
        self.heads = heads
        self.activation = activation
        self.spans = (f"{span}.attn", f"{span}.mlp") if span else None
        self.attn = MultiheadAttention(width)
        self.ln_1 = LayerNorm(width, eps)
        self.mlp = MLP(width, mlp_width)
        self.ln_2 = LayerNorm(width, eps)

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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        a = self.attn
        with self._span(0):
            x = x + mha(
                self.ln_1(x), a.in_proj_weight, a.in_proj_bias,
                a.out_proj.weight, a.out_proj.bias, self.heads, mask, attention_scores,
            )
        with self._span(1):
            h = self.mlp.c_fc(self.ln_2(x))
            return x + self.mlp.c_proj(activate(h, self.activation))

    def forward_fused(
        self,
        x: torch.Tensor,
        h: Optional[torch.Tensor],
        mask: Optional[torch.Tensor],
        ln_next: Optional[LayerNorm],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``forward`` with each residual add fused into the LayerNorm after
        it: ``h`` is ``ln_1(x)`` (None: computed here, for the first block),
        and the block returns its output and ``ln_next`` of it (with
        ``ln_next`` None, the output and None, after a plain add)."""
        a, add_ln = self.attn, ln_act.add_layer_norm
        with self._span(0):
            if h is None:
                h = add_ln(x, None, self.ln_1)[1]
            attn = mha(h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
                       a.out_proj.bias, self.heads, mask, attention)
            x, h = add_ln(x, attn, self.ln_2)
        with self._span(1):
            out = self.mlp.c_proj(activate(self.mlp.c_fc(h), self.activation, fused=True))
            if ln_next is None:
                return x + out, None
            return add_ln(x, out, ln_next)


class Transformer(nn.Module):
    """``span`` names the spans each block records (``ResidualAttentionBlock``);
    None records none. ``activation``, ``mlp_width`` and ``eps``: every
    block's."""

    def __init__(self, width: int, layers: int, heads: int, span: Optional[str] = None,
                 activation: str = "quick_gelu", mlp_width: int = 0, eps: float = 1e-5):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, span, activation, mlp_width, eps)
            for _ in range(layers)
        )

    def init(self, g: torch.Generator) -> None:
        for blk in self.resblocks:
            blk.init(g, len(self.resblocks))

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor],
        records: bool,
        remat: bool = False,
        ln_final: Optional[LayerNorm] = None,
    ) -> torch.Tensor:
        """The blocks over ``x``, then ``ln_final`` where given.
        ``remat=True`` checkpoints each block, so the backward pass
        recomputes its activations (``jax.checkpoint`` of the block body,
        ``hgr_tpu/models/transformer.py:104-107``). ``records`` is the
        tower's answer from ``ln_act.autograd_records``, asked once an
        encode. If it is False, the blocks run fused
        (``ResidualAttentionBlock.forward_fused``), the last block's MLP add
        going into ``ln_final`` (or a plain add without it)."""
        if not records:
            blocks, h = self.resblocks, None
            for i, blk in enumerate(blocks):
                nxt = blocks[i + 1].ln_1 if i + 1 < len(blocks) else ln_final
                x, h = blk.forward_fused(x, h, mask, nxt)
            return x if ln_final is None else h
        for blk in self.resblocks:
            if remat:
                x = checkpoint(blk, x, mask, use_reentrant=False)
            else:
                x = blk(x, mask)
        return x if ln_final is None else ln_final(x)
