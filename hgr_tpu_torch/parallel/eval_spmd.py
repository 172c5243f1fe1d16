"""Sharded zero-shot eval with explicit collectives (port of
``hgr_tpu/parallel/eval_spmd.py:38-176``).

Gathering the full [B, N] logit matrix would send B x N numbers a batch.
This step keeps the logits local and merges only the small decision state:

- each (data, model) rank computes LOCAL logits [B/data, N/model] of its
  slice of the batch against its shard of the depth-sorted bank;
- flat Hit@k: a local top-maxk over the test-masked local logits, a gather
  of (values, global sorted ids) over ``model`` (S x maxk numbers a row
  instead of N) and a merged top-maxk;
- the per-level constrained argmax and TOR: a local masked argmax per level
  with the reference's FILL rule (out-of-level TRAIN candidates stay in the
  race at -1), a gather over ``model`` and the first max over shards (the
  lowest shard wins a tie). The depth-sorted bank shards into contiguous
  ranges of sorted ids, so this is the one-device order exactly;
- the metrics' partial sums, summed over ``data``.

``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order among them; a stable descending sort gives
``lax.top_k``'s order, in the local top-k and in the merge alike.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..eval.bank import bank_logits
from ..eval.metrics import FILL, NEG, TOPK, BatchMetrics, _path_point
from ..models.clip import encode_image
from .collectives import all_sum_, gather_slots
from .mesh import Mesh


def all_sum_metrics(m: BatchMetrics, group) -> BatchMetrics:
    """The partial sums of ``m`` summed over ``group`` (the ``psum`` over
    ``data``), in one collective."""
    if group is None:
        return m
    packed = all_sum_(torch.cat([m.hits, torch.stack([m.tor, m.path, m.point, m.num])]), group)
    k = m.hits.shape[0]
    return BatchMetrics(hits=packed[:k], tor=packed[k], path=packed[k + 1], point=packed[k + 2],
                        num=packed[k + 3])


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class ShardedEval:
    """``step(bank_shard, images, target, valid) -> BatchMetrics`` of one
    single-class batch on a mesh: ``bank_shard`` is this rank's
    ``mesh.bank_shard`` of the depth-sorted bank, ``images`` and ``valid``
    its ``mesh.batch_shard`` of the batch. The result, summed over the
    mesh, is the same on every rank."""

    def __init__(self, tm, mesh: Mesh, topk: Sequence[int] = TOPK):
        if tm.n_pad % mesh.model:
            raise ValueError(f"N_pad {tm.n_pad} does not divide over model axis {mesh.model}")
        self.tm, self.mesh, self.topk = tm, mesh, tuple(topk)
        tb = tm._sorted_tables
        order = tm.depth_order
        n_loc = tm.n_pad // mesh.model
        lo = mesh.model_index * n_loc
        local = slice(lo, lo + n_loc)
        dev = tm.device
        self.base = lo
        self.order = tb["order"]
        self.depth_loc = torch.as_tensor(tm.node_depth[order][local], device=dev).long()
        self.train_loc = tb["train_s"][local]
        self.test_loc = tb["test_s"][local]
        self.chains, self.chain_len, self.chain_levels = (
            tb["chains"], tb["chain_len"], tb["chain_levels"])
        self.levels = list(range(tm.hier.max_depth + 1)) + [-1]
        self.ks = torch.tensor([k - 1 for k in self.topk], device=dev)

    @torch.inference_mode()
    def __call__(self, bank_shard: torch.Tensor, images: torch.Tensor, target: int,
                 valid: Optional[torch.Tensor] = None) -> BatchMetrics:
        feats = encode_image(self.tm.model, images, dtype=self.tm.dtype)
        return self.metrics_from_logits(bank_logits(feats, bank_shard), target, valid)

    @torch.inference_mode()
    def merged_preds(self, logits: torch.Tensor):
        """This data slice's predictions from this rank's local logits
        [B/data, N/model] (fp32, depth-sorted columns), merged over
        ``model``: the top-maxk test classes' logits and node ids [B, maxk],
        and the per-level (then TOR) argmax node ids [L+1, B]. The same on
        every rank of a data row."""
        group = self.mesh.model_group
        B, n_loc = logits.shape
        order = self.order

        # flat top-k over the test classes; a shard smaller than maxk gives
        # all of its columns, which keeps the merge exact
        maxk = max(self.topk)
        lv, li = _top_k(torch.where(self.test_loc[None, :], logits, NEG), min(maxk, n_loc))
        gv = gather_slots(lv, group).transpose(0, 1).reshape(B, -1)          # [B, S k]
        gi = gather_slots(li + self.base, group).transpose(0, 1).reshape(B, -1)
        top_vals, mi = _top_k(gv, maxk)
        top_ids = order[gi.gather(1, mi)]                                     # [B, maxk]

        # per-level argmax with the FILL rule, then the first max over shards
        vals, idx = [], []
        for lev in self.levels:
            in_level = self.depth_loc == lev if lev >= 0 else torch.ones_like(self.train_loc)
            v = torch.where(self.train_loc[None, :],
                            torch.where(in_level[None, :], logits, FILL), NEG)
            a = v.argmax(dim=1)
            vals.append(v.gather(1, a[:, None])[:, 0])
            idx.append(a + self.base)
        g_vals = gather_slots(torch.stack(vals), group)                       # [S, L+1, B]
        g_idx = gather_slots(torch.stack(idx), group)
        best = g_vals.argmax(dim=0)                                           # first max
        return top_vals, top_ids, order[g_idx.gather(0, best[None])[0]]       # [L+1, B]

    @torch.inference_mode()
    def metrics_from_logits(self, logits: torch.Tensor, target: int,
                            valid: Optional[torch.Tensor] = None) -> BatchMetrics:
        """The merge from this rank's local logits [B/data, N/model] (fp32,
        depth-sorted columns)."""
        if valid is None:
            valid = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
        _, pred, preds_global = self.merged_preds(logits)
        correct = (pred == target) & valid[:, None]
        hits = correct.cumsum(dim=1)[:, self.ks].sum(dim=0).to(torch.float32)

        chain = self.chains[target]
        chain_len = self.chain_len[target]
        tor_pred = preds_global[-1]
        in_chain = (tor_pred[:, None] == chain[None, :]) & (chain[None, :] >= 0)
        tor = (in_chain.any(dim=1) & valid).sum().to(torch.float32)
        preds = preds_global[self.chain_levels[target]].T                     # [B, Lmax]
        pos_valid = torch.arange(chain.shape[0], device=chain.device)[None, :] < chain_len
        match = (preds == chain[None, :]) & pos_valid & valid[:, None]
        path, point = _path_point(match, chain_len)
        num = valid.sum().to(torch.float32)

        return all_sum_metrics(BatchMetrics(hits=hits, tor=tor, path=path, point=point, num=num),
                               self.mesh.data_group)


def make_sharded_eval_step(tm, mesh: Mesh, topk: Sequence[int] = TOPK) -> ShardedEval:
    """The sharded eval step of ``tm`` on ``mesh`` (see :class:`ShardedEval`)."""
    return ShardedEval(tm, mesh, topk)
