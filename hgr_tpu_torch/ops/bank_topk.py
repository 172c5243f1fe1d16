"""Hierarchical level-argmax over the class-logit matrix (port of
``hgr_tpu/ops/bank_topk.py``).

The hierarchical metrics need, per eval batch, the constrained argmax over
{candidate classes at depth(chain[j])} for every ancestor-chain position,
plus the unconstrained candidate argmax (TOR). ``level_argmax_sorted`` is
the production path: with the class axis permuted so that each depth is a
contiguous column range, every level's argmax is an argmax over a fixed
slice. ``level_argmax_xla`` (named after its JAX counterpart) is the
per-level masked oracle.

Fill semantics: the reference keeps out-of-level TRAIN candidates in the
race at value -1 (``main.py:169-171`` ``index_fill``). ``level_argmax_xla``
reproduces this with a two-tier mask; ``level_argmax_sorted``, whose slices
cannot leave the level, returns each slot's max value so that the metrics
can apply the same condition (``eval/metrics.metrics_from_preds``).

``torch.argmax`` returns the first maximal index, the tie rule of
``jnp.argmax``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG = -1e9
FILL = -1.0  # the reference's index_fill value (main.py:169-171)


def level_argmax_xla(
    logits: torch.Tensor,      # [B, N] fp32
    levels: torch.Tensor,      # [L] int (depth per slot; -1 = all)
    node_depth: torch.Tensor,  # [N] int
    train_mask: torch.Tensor,  # [N] bool
) -> torch.Tensor:
    """Reference implementation -> preds [L, B] int32."""
    preds = []
    for lev in levels.tolist():
        in_level = torch.ones_like(train_mask) if lev < 0 else node_depth == lev
        masked = torch.where(
            train_mask[None, :],
            torch.where(in_level[None, :], logits, FILL),
            NEG,
        )
        preds.append(masked.argmax(dim=1).to(torch.int32))
    return torch.stack(preds)


def level_argmax_sorted(
    logits_sorted: torch.Tensor,        # [B, N] logits in depth-sorted class order
    level_offsets: Sequence[int],       # start offset of each depth; len L+1
    train_mask_sorted: torch.Tensor,    # [N] bool in sorted order
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(preds, vals)``, each [n_levels + 1, B]: the sorted-space
    argmax per slot (the last slot is the train-masked argmax over all
    classes, TOR) and the slot's max masked value."""
    B = logits_sorted.shape[0]
    outs, vals = [], []

    def take(sl, lo):
        a = sl.argmax(dim=1)
        outs.append((a + lo).to(torch.int32))
        vals.append(sl.gather(1, a[:, None])[:, 0])

    for d in range(len(level_offsets) - 1):
        lo, hi = level_offsets[d], level_offsets[d + 1]
        if hi == lo:
            outs.append(torch.zeros(B, dtype=torch.int32, device=logits_sorted.device))
            vals.append(torch.full((B,), NEG, dtype=logits_sorted.dtype,
                                   device=logits_sorted.device))
            continue
        m = train_mask_sorted[lo:hi]
        take(torch.where(m[None, :], logits_sorted[:, lo:hi], NEG), lo)
    take(torch.where(train_mask_sorted[None, :], logits_sorted, NEG), 0)
    return torch.stack(outs), torch.stack(vals)
