"""Parameter trees and optax-style Adam for the baselines.

The JAX baselines keep their weights as nested dicts of arrays and step
them with ``optax.adam`` / ``optax.adamw``. Here the same trees hold torch
tensors, and :class:`Adam` is ``torch.optim.Adam`` (or ``AdamW``) over a
tree's leaves with optax's defaults: ``eps=1e-8`` added to the square root
of the second moment, and ``optax.adamw``'s weight decay of 1e-4 (torch's
default is 1e-2).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

OPTAX_ADAMW_DECAY = 1e-4


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree, in its order; a module gives its ``state_dict``
    tensors by reference."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def from_numpy(tree: Any, device=None, requires_grad: bool = True) -> Any:
    """A tree of numpy arrays (JAX ones through ``np.asarray``) or tensors as
    float32 tensor copies on ``device``: how the tests carry JAX weights
    across, and how the inits place theirs."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().to(device or x.device, torch.float32, copy=True)
        else:
            t = torch.as_tensor(np.asarray(x, np.float32), device=device).clone()
        return t.requires_grad_(requires_grad)
    return tree_map(leaf, tree)


def grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for every leaf, zeros where the loss does not use it
    (``jax.grad``'s convention; FREE's D step leaves FR's heads out)."""
    return list(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))


class Adam:
    """``optax.adam(lr, b1)`` or, with ``weight_decay``, ``optax.adamw``:
    ``init(params)`` makes the torch optimizer over the tree's leaves,
    ``update(params, opt)`` steps it on their ``.grad`` and clears them."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: Optional[float] = None):
        self.lr, self.betas, self.eps, self.weight_decay = lr, (b1, b2), eps, weight_decay

    def init(self, params: Any) -> torch.optim.Optimizer:
        leaves = tree_leaves(params)
        if self.weight_decay is None:
            return torch.optim.Adam(leaves, lr=self.lr, betas=self.betas, eps=self.eps)
        return torch.optim.AdamW(leaves, lr=self.lr, betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)

    @torch.no_grad()
    def update(self, params: Any, opt: torch.optim.Optimizer) -> None:
        for t in tree_leaves(params):
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        opt.step()
        opt.zero_grad(set_to_none=True)

    def apply(self, params: Any, opt: torch.optim.Optimizer, grads: List[torch.Tensor]) -> None:
        """Step with ``grads``, one per leaf (from :func:`grads`)."""
        for t, g in zip(tree_leaves(params), grads):
            t.grad = g
        self.update(params, opt)
