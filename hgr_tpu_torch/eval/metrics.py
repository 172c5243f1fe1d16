"""Hierarchical zero-shot metrics over tensors (port of
``hgr_tpu/eval/metrics.py``).

Exact behavioural equivalents of the reference's eval loop
(``main.py:136-191``):

- flat Hit@{1,2,5,10,20} over the unseen (test) class subset
  (``main.py:136-148``), from the target's rank in one masked pass;
- TOR / "hit_ratio": top-1 over candidate (train) classes landing in
  {target and its ancestors} (``main.py:152-160``);
- POR / "point_ratio" and "path_ratio": the per-ancestor-level constrained
  argmax (the reference's ``index_fill(-1)`` per level, ``main.py:162-176``)
  gives a predicted path, scored by node and edge overlap with the ground
  truth root path (``main.py:177-191``).

All functions assume the grouped-loader invariant (every image in the batch
shares one target class, reference ``main.py:152`` uses ``targets[0]``) and
return partial sums that the caller accumulates.

Hit@k ranks ties as ``lax.top_k`` does: the lower column comes first. Test
classes do tie: two classes with the same prompt share a bank row, so their
logits are equal. ``torch.topk`` promises no order among equal values, so
the target's rank is counted instead (:func:`_rank_hits`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

NEG = -1e9  # true exclusion (column-restriction semantics, e.g. topk/TOR)
# The per-level constrained argmax does NOT truly exclude out-of-level
# candidates: the reference fills them with -1 (``main.py:169-171``,
# ``index_fill(1, rest, -1)``) and -1 IS reachable for cosine*scale logits:
# when every same-level candidate scores below -1, the reference predicts an
# out-of-level node (a guaranteed miss at that level).
FILL = -1.0
TOPK: Tuple[int, ...] = (1, 2, 5, 10, 20)


class BatchMetrics(NamedTuple):
    """Partial sums for one single-class batch (fp32 scalars; hits [K])."""

    hits: torch.Tensor   # [len(TOPK)] counts of target-in-top-k
    tor: torch.Tensor    # count of top-1-in-{target u ancestors}
    path: torch.Tensor   # path_ratio numerator contribution
    point: torch.Tensor  # point_ratio numerator contribution
    num: torch.Tensor    # number of samples in the batch


def _rank_hits(masked: torch.Tensor, col, topk, valid) -> torch.Tensor:
    """Counts of "column ``col`` among the first k" of each row of ``masked``,
    in ``lax.top_k``'s order (descending, the lower column first on ties).
    The target's rank is the number of entries strictly greater than its
    value plus the equal ones at a lower column; it is a hit when that rank
    is below k."""
    col = torch.as_tensor(col, device=masked.device).long()
    t = masked.index_select(1, col.reshape(1))                         # [B, 1]
    lower = torch.arange(masked.shape[1], device=masked.device) < col  # [N]
    rank = torch.where(lower[None, :], masked >= t, masked > t).sum(dim=1)
    hit = rank[:, None] < torch.tensor(list(topk), device=masked.device)[None, :]
    if valid is not None:
        hit = hit & valid[:, None]
    return hit.sum(dim=0).to(torch.float32)


def _path_point(match: torch.Tensor, chain_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(path, point) numerators from the [B, Lmax] chain-slot matches."""
    Lmax = match.shape[1]
    L = chain_len.to(torch.float32)
    point = (match.sum(dim=1).to(torch.float32) / L).sum()
    edge_pair = match[:, :-1] & match[:, 1:]
    pair_valid = (torch.arange(Lmax - 1, device=match.device)[None, :] + 1) < chain_len
    edges = (edge_pair & pair_valid).sum().to(torch.float32)
    path_single = match[:, 0].sum().to(torch.float32)  # L == 1 case
    path = torch.where(chain_len == 1, path_single, edges / torch.clamp_min(L - 1.0, 1.0))
    return path, point


def _num(rows: int, valid, device) -> torch.Tensor:
    if valid is None:
        return torch.tensor(float(rows), device=device)
    return valid.sum().to(torch.float32)


def flat_hits(
    logits: torch.Tensor,       # [B, N] full-node logits
    target,                     # scalar class id (single-class batch)
    test_mask: torch.Tensor,    # [N] bool: unseen/test candidate classes
    topk: Sequence[int] = TOPK,
    valid: Optional[torch.Tensor] = None,  # [B] bool row mask (padded batches)
) -> torch.Tensor:
    """Counts of "target in top-k over the test subset" for each k."""
    masked = torch.where(test_mask[None, :], logits, NEG)
    return _rank_hits(masked, target, topk, valid)


def tor_hits(
    logits: torch.Tensor,       # [B, N]
    chain: torch.Tensor,        # [L] padded chain (ancestors + self), PAD=-1
    train_mask: torch.Tensor,   # [N] bool: candidate classes for top-1
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Top-Overlap Ratio numerator: top-1 over candidates in the chain set."""
    pred = torch.where(train_mask[None, :], logits, NEG).argmax(dim=1)
    in_chain = (pred[:, None] == chain[None, :]) & (chain[None, :] >= 0)
    hit = in_chain.any(dim=1)
    if valid is not None:
        hit = hit & valid
    return hit.sum().to(torch.float32)


def path_point(
    logits: torch.Tensor,       # [B, N]
    chain: torch.Tensor,        # [Lmax] padded (ancestors + self)
    chain_len: torch.Tensor,    # scalar int, actual length L >= 1
    node_depth: torch.Tensor,   # [N] int depth per node
    train_mask: torch.Tensor,   # [N] bool
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(path numerator, point numerator) for one batch: for each chain
    position the predicted node is the constrained argmax over
    {candidates at depth(chain[j])}, with the reference's fill semantics
    (out-of-level train candidates stay in the race at FILL)."""
    levels = torch.where(chain >= 0, node_depth[chain.clamp_min(0)], -1)
    preds = torch.stack([
        torch.where(
            train_mask[None, :],
            torch.where((node_depth == lev)[None, :], logits, FILL),
            NEG,
        ).argmax(dim=1)
        for lev in levels
    ], dim=1)                                          # [B, Lmax]
    pos_valid = torch.arange(chain.shape[0], device=logits.device)[None, :] < chain_len
    match = (preds == chain[None, :]) & pos_valid
    if valid is not None:
        match = match & valid[:, None]
    return _path_point(match, chain_len)


def batch_metrics(
    logits: torch.Tensor,
    target,
    chain: torch.Tensor,
    chain_len: torch.Tensor,
    node_depth: torch.Tensor,
    train_mask: torch.Tensor,
    test_mask: torch.Tensor,
    topk: Sequence[int] = TOPK,
    valid: Optional[torch.Tensor] = None,
) -> BatchMetrics:
    hits = flat_hits(logits, target, test_mask, topk, valid=valid)
    tor = tor_hits(logits, chain, train_mask, valid=valid)
    path, point = path_point(logits, chain, chain_len, node_depth, train_mask, valid=valid)
    num = _num(logits.shape[0], valid, logits.device)
    return BatchMetrics(hits=hits, tor=tor, path=path, point=point, num=num)


def metrics_from_preds(
    preds_global: torch.Tensor,   # [L_all + 1, B] global-id argmax per depth (+ TOR row last)
    logits_sorted: torch.Tensor,  # [B, N] logits in depth-sorted class order
    order: torch.Tensor,          # [N] sorted-index -> global node id
    target,
    chain: torch.Tensor,          # [Lmax] padded chain (ancestors + self)
    chain_len: torch.Tensor,
    chain_levels: torch.Tensor,   # [Lmax] depth of each chain slot (PAD -> 0)
    test_mask_sorted: torch.Tensor,
    topk: Sequence[int] = TOPK,
    valid: Optional[torch.Tensor] = None,
    lvl_vals: Optional[torch.Tensor] = None,      # [L_all + 1, B] slot max values
    fill_outside: Optional[torch.Tensor] = None,  # [L_all + 1] bool: a train
    # node OUTSIDE the slot's level exists (the reference's -1 fill
    # competitor). Given with lvl_vals, a slot whose best level candidate
    # scores <= FILL counts as a miss (main.py:169-171 semantics).
) -> BatchMetrics:
    """Metrics on the depth-sorted fast path: the results of
    :func:`batch_metrics` from one pass over the logits.

    Exact-tie boundary: ``beats_fill`` is a strict ``> FILL`` test, so a
    level whose best train candidate scores exactly -1.0 is a miss, as in
    ``hgr_tpu/eval/metrics.py:188-193``.
    """
    masked = torch.where(test_mask_sorted[None, :], logits_sorted, NEG)
    # ties rank by depth-sorted position, as lax.top_k over this layout does
    hits = _rank_hits(masked, torch.argmax((order == target).to(torch.int8)), topk, valid)

    tor_pred = preds_global[-1]               # [B]
    in_chain = (tor_pred[:, None] == chain[None, :]) & (chain[None, :] >= 0)
    tor_hit = in_chain.any(dim=1)
    if valid is not None:
        tor_hit = tor_hit & valid
    tor = tor_hit.sum().to(torch.float32)

    preds = preds_global[chain_levels].T      # [B, Lmax] per-chain-slot predictions
    pos_valid = torch.arange(chain.shape[0], device=chain.device)[None, :] < chain_len
    match = (preds == chain[None, :]) & pos_valid
    if lvl_vals is not None and fill_outside is not None:
        beats_fill = lvl_vals[chain_levels].T > FILL
        match = match & (beats_fill | ~fill_outside[chain_levels][None, :])
    if valid is not None:
        match = match & valid[:, None]
    path, point = _path_point(match, chain_len)
    num = _num(logits_sorted.shape[0], valid, logits_sorted.device)
    return BatchMetrics(hits=hits, tor=tor, path=path, point=point, num=num)


def accumulate(a: BatchMetrics, b: BatchMetrics) -> BatchMetrics:
    return BatchMetrics(*(x + y for x, y in zip(a, b)))


def zeros_metrics(n_topk: int = len(TOPK), device=None) -> BatchMetrics:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return BatchMetrics(
        hits=torch.zeros(n_topk, dtype=torch.float32, device=device),
        tor=z, path=z, point=z, num=z,
    )


def summarize(m: BatchMetrics, topk: Sequence[int] = TOPK) -> Dict[str, float]:
    """Final percentages, reference naming (``count_acc`` + ratio lines,
    ``main.py:193-216``)."""
    num = float(m.num)
    out = {f"hit@{k}": float(h) / num * 100.0 for k, h in zip(topk, m.hits.tolist())}
    out["tor"] = float(m.tor) / num * 100.0
    out["path_ratio"] = float(m.path) / num * 100.0
    out["point_ratio"] = float(m.point) / num * 100.0
    out["num_samples"] = num
    return out
