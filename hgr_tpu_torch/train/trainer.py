"""Train step assembly: optimizers, gradient clipping, the update (port of
``hgr_tpu/train/trainer.py:32-152``).

The reference driver's optimizer setup (``main.py:246-253``), with the JAX
package's optax semantics kept exactly:

- AdamW(lr, wd) over every CLIP tensor, after a global-norm clip that
  covers those tensors only (``main.py:87-88``); the clip scales by
  ``max / norm`` only when ``norm >= max``, as ``optax.clip_by_global_norm``
  does (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm);
- SGD(w_lr) over the adaptive ``layer_weight``, unclipped;
- extra top-level groups labelled ``"clip"``, ``"lw"`` or ``"frozen"``;
- the cosine schedule read at the count of updates already applied, which
  is where optax evaluates it (a ``LambdaLR`` would be one step late);
- ``accum_steps > 1`` as ``optax.MultiSteps``: the k micro-gradients are
  averaged (a running mean), the average is clipped, and the parameters
  and the schedule's count move only on the k-th call.

"The CLIP tensors" are the JAX pytree's leaves, which ``convert`` maps one
to one onto the module's ``state_dict``: its parameters and the ResNet's
BatchNorm running statistics, which the JAX step updates like any leaf.
Master tensors stay fp32; the modules cast to the compute dtype where the
JAX functions do, so gradients come back fp32 (no ``torch.autocast``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..utils.profiling import annotate
from .om import make_om_loss_fn
from .sampling import PairSchedule
from .schedule import cosine_lr

LABELS = ("clip", "lw", "frozen")


def leaves(value: Any) -> List[torch.Tensor]:
    """The tensors of one top-level entry of ``params``: a module's
    ``state_dict`` tensors (by reference), or the tensor itself."""
    if isinstance(value, nn.Module):
        return list(value.state_dict(keep_vars=True).values())
    return [value]


@dataclass
class OptState:
    """Optimizer state: the AdamW and SGD moments, the accumulated
    micro-gradients (``MultiSteps``), and the counts."""

    adamw: Optional[torch.optim.AdamW]
    sgd: Optional[torch.optim.SGD]
    acc: List[torch.Tensor] = field(default_factory=list)
    mini_step: int = 0   # micro-steps accumulated towards the next update
    count: int = 0       # updates applied (the schedule's step)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "adamw": None if self.adamw is None else self.adamw.state_dict(),
            "sgd": None if self.sgd is None else self.sgd.state_dict(),
            "acc": list(self.acc),
            "mini_step": self.mini_step,
            "count": self.count,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for name in ("adamw", "sgd"):
            if getattr(self, name) is not None:
                getattr(self, name).load_state_dict(sd[name])
        with torch.no_grad():
            for a, b in zip(self.acc, sd["acc"]):
                a.copy_(b)
        self.mini_step, self.count = int(sd["mini_step"]), int(sd["count"])


class Optimizer:
    """``optax.multi_transform({"clip": chain(clip_by_global_norm, adamw),
    "lw": sgd, "frozen": set_to_zero})``, in ``MultiSteps`` when
    ``accum_steps > 1``, applied in place to the tensors' ``.grad``."""

    def __init__(self, config: Config, total_steps: int, labels: Dict[str, str]):
        self.labels = labels
        self.schedule = cosine_lr(config.lr, config.warmup_length, total_steps)
        self.grad_clip = config.grad_clip
        self.wd = config.wd
        self.w_lr = config.w_lr
        self.accum_steps = max(1, config.accum_steps)

    def groups(self, params: Dict[str, Any]) -> Dict[str, List[torch.Tensor]]:
        out: Dict[str, List[torch.Tensor]] = {name: [] for name in LABELS}
        for key, label in self.labels.items():
            out[label] += leaves(params[key])
        return out

    def init(self, params: Dict[str, Any]) -> OptState:
        g = self.groups(params)
        # fused on the card: one kernel for the whole group
        adamw = torch.optim.AdamW(g["clip"], lr=self.schedule(0), weight_decay=self.wd,
                                  fused=g["clip"][0].is_cuda) if g["clip"] else None
        sgd = torch.optim.SGD(g["lw"], lr=self.w_lr) if g["lw"] else None
        acc = [torch.zeros_like(t, memory_format=torch.preserve_format)
               for t in g["clip"] + g["lw"]] if self.accum_steps > 1 else []
        return OptState(adamw, sgd, acc)

    @torch.no_grad()
    def update(self, params: Dict[str, Any], st: OptState) -> None:
        """Apply one micro-step's gradients and clear them; while
        accumulating, only the running mean moves."""
        g = self.groups(params)
        trained = g["clip"] + g["lw"]
        grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in trained]
        for t in trained:
            t.grad = None
        if self.accum_steps > 1:
            for a, x in zip(st.acc, grads):
                a.add_((x - a) / (st.mini_step + 1))
            st.mini_step += 1
            if st.mini_step < self.accum_steps:
                return
            st.mini_step = 0
            grads = [a.clone() for a in st.acc]
            for a in st.acc:
                a.zero_()
        n = len(g["clip"])
        if n:  # multi-tensor kernels: a step has ~300 CLIP tensors
            norm = torch.nn.utils.get_total_norm(grads[:n])
            torch._foreach_mul_(grads[:n], torch.where(norm < self.grad_clip, 1.0,
                                                       self.grad_clip / norm))
        for t, x in zip(trained, grads):
            t.grad = x
        if st.adamw is not None:
            for group in st.adamw.param_groups:
                group["lr"] = self.schedule(st.count)
            st.adamw.step()
        if st.sgd is not None:
            st.sgd.step()
        for t in trained:
            t.grad = None
        st.count += 1


def make_optimizer(
    config: Config, total_steps: int, extra_labels: Optional[Dict[str, str]] = None
) -> Optimizer:
    """AdamW(clip) + SGD(layer_weight), with optional extra groups labelled
    ``"clip"``, ``"lw"`` or ``"frozen"`` (no update)."""
    labels = {"clip": "clip", "layer_weight": "lw"}
    labels.update(extra_labels or {})
    return Optimizer(config, total_steps, labels)


@dataclass
class TrainState:
    params: Dict[str, Any]   # {"clip": CLIP module, "layer_weight": [L] fp32, ...}
    opt_state: OptState
    step: int = 0            # train-step calls (micro-steps under accumulation)


def sched_to_device(s: PairSchedule, device) -> Dict[str, torch.Tensor]:
    """The schedule's arrays that the loss reads, on ``device``: indices as
    int64, masks as bool."""
    def t(x, dtype=torch.long):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return {
        "compare_valid": t(s.compare_valid, torch.bool),
        "label": t(s.label),
        "in_pos": t(s.in_pos),
        "in_len": t(s.in_len),
        "out_pos": t(s.out_pos),
        "out_len": t(s.out_len),
        "pair_valid": t(s.pair_valid, torch.bool),
        "unique": t(s.unique),
        "inv": t(s.inv),
    }


def freeze_params(params: Dict[str, Any], frozen: tuple) -> Dict[str, Any]:
    """Gradients off for the ``frozen`` top-level entries and on for the
    rest: the JAX ``stop_gradient`` of the frozen subtrees, so their
    backward is never run."""
    for key, value in params.items():
        for t in leaves(value):
            t.requires_grad_(key not in frozen)
    return params


def make_train_step(
    config: Config,
    tx: Optimizer,
    dtype: torch.dtype = torch.bfloat16,
    text_fn: Callable = None,
    frozen: tuple = (),
) -> Callable:
    """-> ``step(state, images, node_tokens, sched) -> (state, loss)``,
    which updates ``state`` in place; ``loss`` is a detached 0-d tensor on
    the step's device."""
    loss_fn = make_om_loss_fn(
        dtype, config.training_method, config.weights, config.weighting,
        remat=config.remat, text_fn=text_fn,
    )

    def step(state: TrainState, images, node_tokens, sched):
        with annotate("trainer.step"):
            params = freeze_params(state.params, frozen)
            with annotate("trainer.loss"):
                loss = loss_fn(params, images, node_tokens, sched)
            with annotate("trainer.backward"):
                loss.backward()
            with annotate("trainer.update"):
                tx.update(params, state.opt_state)
            state.step += 1
            return state, loss.detach()

    return step


def init_train_state(
    model: nn.Module,
    layer_weight: torch.Tensor,
    tx: Optimizer,
    extra_params: Optional[Dict[str, Any]] = None,
) -> TrainState:
    """A state whose params are ``model`` and ``layer_weight`` themselves:
    the step updates the TreeModel's weights in place."""
    params = {"clip": model, "layer_weight": layer_weight}
    params.update(extra_params or {})
    return TrainState(params=params, opt_state=tx.init(params))
