"""The mesh's collectives (the port's own: XLA emits these from shardings
and ``shard_map``, so the JAX package has no counterpart).

Every collective here is an ``all_reduce``. A gather is an ``all_reduce(SUM)``
over a zero buffer in which each rank fills its own slot: adding zeros is
exact, so the result is the gathered tensor bit for bit. Of gloo's
collectives only broadcast and all_reduce take CUDA tensors, so this one
form runs over NCCL, over gloo on the CPU, and over gloo on CUDA tensors
(several ranks sharing one card). The eval merge sends S x B x (maxk + L
+ 1) numbers a batch and training gathers a replica's ``[B, D]`` and
``[U, D]`` features; only the gradient sum is the model's size, one flat
buffer a dtype (``all_sum_flat_``).

A group of ``None`` is a 1 x 1 mesh without a process group: every
collective is then the identity.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In place: the sum of ``x`` over ``group``."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_slots(x: torch.Tensor, group) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` in the group's rank order
    (JAX's ``all_gather`` over an axis). Every rank's ``x`` has one shape."""
    if group is None:
        return x[None]
    buf = x.new_zeros((group_size(group),) + tuple(x.shape))
    buf[group_index(group)] = x
    return all_sum_(buf, group)


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' row blocks, concatenated in rank order.
    Backward: the gradient of the whole, summed over the group, and this
    rank's block of it (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return gather_slots(x, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        grad = all_sum_(grad.contiguous().clone(), ctx.group)
        i = group_index(ctx.group)
        return grad[i * ctx.rows: (i + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[S * R, ...]`` from every rank's ``[R, ...]``, differentiable."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


def all_sum_flat_(tensors: List[torch.Tensor], group, scale: Optional[float] = None) -> None:
    """In place: each tensor summed over ``group`` (then times ``scale``),
    through one flat buffer a dtype, so that a step of ~300 gradients is a
    few collectives."""
    if group is None and scale in (None, 1.0):
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        all_sum_(flat, group)
        if scale is not None:
            flat.mul_(scale)
        off = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[off: off + n].view_as(t))
            off += n
