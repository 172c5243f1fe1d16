"""Multi-replica (SPMD) OM training: one class per data replica a step, the
encoder passes split over the whole mesh (port of
``hgr_tpu/train/spmd.py:41-155``).

Every batch is one class, so splitting one class's batch over ranks would
leave every rank encoding the same prompts. Instead each data row d is a
replica with its OWN class batch and pair schedule; the replica losses are
averaged and one optimizer update follows, the same on every rank.

The ranks of a row split that replica's work, as JAX's ``P((DATA, MODEL))``
resharding does: rank (d, m) encodes the m-th of M contiguous blocks of the
replica's images and of its de-duplicated prompts (each padded to a
multiple of M: zero images, and prompt id 0, which encodes harmlessly). The
features are gathered back over the row (``collectives.gather_rows``), and
``pair_ce_loss`` runs on the replica's full features on every rank of the
row. Frozen-statistics BatchNorm keeps an image's features independent of
its block, so the split is exact.

The gradient scale: every rank of a row computes the same loss L_d, and the
gather's backward sums the features' gradient over the row, so each row
contributes M times the gradient of L_d (through the features, and through
``layer_weight`` and ``logit_scale``, which every rank of the row computes).
The gradients are summed over the world and divided by R x M: the gradient
of the mean of the R replica losses. Every rank then clips and applies the
same update to the same parameters, so they stay bitwise equal.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..models.clip import encode_image, encode_text
from ..models.layers import l2_normalize
from ..parallel.collectives import all_sum_, all_sum_flat_, gather_rows
from ..parallel.mesh import Mesh
from .om import pair_ce_loss, resolve_weight_modes
from .sampling import PairSchedule
from .trainer import Optimizer, TrainState, freeze_params, sched_to_device


def stack_schedules(scheds: List[PairSchedule]) -> Dict[str, np.ndarray]:
    """Stack R per-replica schedules into [R, ...] arrays. The unique-prompt
    sets may differ in size; they are padded to the largest with id 0,
    which encodes harmlessly (``inv`` never points at a pad)."""
    u_max = max(s.unique.shape[0] for s in scheds)

    def pad_u(u):
        out = np.zeros(u_max, u.dtype)
        out[: u.shape[0]] = u
        return out

    keys = ("compare", "compare_valid", "label", "in_pos", "in_len", "out_pos", "out_len",
            "pair_valid", "inv")
    out = {k: np.stack([getattr(s, k) for s in scheds]) for k in keys}
    out["unique"] = np.stack([pad_u(s.unique) for s in scheds])
    return out


def _block(x: torch.Tensor, m: int, M: int) -> torch.Tensor:
    """The m-th of M equal row blocks of ``x``, after padding its rows with
    zeros to a multiple of M."""
    per = -(-x.shape[0] // M)
    pad = per * M - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x[m * per: (m + 1) * per]


def make_spmd_train_step(
    config: Config,
    tx: Optimizer,
    mesh: Mesh,
    dtype: torch.dtype = torch.bfloat16,
    text_fn: Callable = None,
    frozen: tuple = (),
) -> Callable:
    """-> ``step(state, images [R, B, ...], node_tokens, sched [R, ...])
    -> (state, loss)``, JAX's signature: ``R`` is the mesh's ``data``
    size, ``images`` and the stacked schedule (``stack_schedules``) hold
    every replica (host arrays; ``images`` may be a tensor), and this rank
    moves only its replica's to its device. ``state`` is updated in place; ``loss`` is the
    mean of the replica losses, the same on every rank. ``frozen`` top-level
    params take no gradient, so their backward never runs."""
    in_mode, out_mode = resolve_weight_modes(config.training_method, config.weights,
                                             config.weighting)
    R, M = mesh.data, mesh.model
    d, m = mesh.data_index, mesh.model_index
    world = None if mesh.model_group is None else dist.group.WORLD

    def replica_loss(params, images, node_tokens, sched):
        clip = params["clip"]
        B = images.shape[0]
        img = encode_image(clip, _block(images, m, M), dtype=dtype, remat=config.remat)
        img = gather_rows(l2_normalize(img), mesh.model_group)[:B]
        U = sched["unique"].shape[0]
        ids = _block(sched["unique"], m, M)
        if text_fn is None:
            tf = l2_normalize(encode_text(clip, node_tokens[ids], dtype=dtype,
                                          remat=config.remat))
        else:
            tf = text_fn(params, ids)
        tf = gather_rows(tf, mesh.model_group)[:U]
        return pair_ce_loss(img, tf, sched, params["layer_weight"], torch.exp(clip.logit_scale),
                            in_mode=in_mode, out_mode=out_mode)

    def step(state: TrainState, images, node_tokens, sched):
        params = freeze_params(state.params, frozen)
        dev = node_tokens.device
        img_d = torch.as_tensor(images[d]).to(dev)
        sched_d = sched_to_device(SimpleNamespace(**{k: v[d] for k, v in sched.items()}), dev)
        loss = replica_loss(params, img_d, node_tokens, sched_d)
        loss.backward()
        groups = tx.groups(params)
        trained = groups["clip"] + groups["lw"]
        for t in trained:
            if t.grad is None:  # every rank sums the same list of tensors
                t.grad = torch.zeros_like(t)
        all_sum_flat_([t.grad for t in trained], world, scale=1.0 / (R * M))
        tx.update(params, state.opt_state)
        state.step += 1
        loss = all_sum_(loss.detach().clone(), world) / (R * M)
        return state, loss

    return step
