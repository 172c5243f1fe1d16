"""The comparisons that decide ``correct``.

Each returns one number; a run is correct when every number is at or under
its limit (``benchmark/limits/<cell>.json``), where the limits were set
from sound runs of the program and from the control (``PERF.md``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import normalize

TOPK = (1, 2, 5, 10, 20)


def row_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest L2 distance between matching unit rows."""
    return float((prog.double() - ref.double()).norm(dim=1).max())


def frob_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """``|prog - ref| / |ref|`` over all rows together (Frobenius norms)."""
    return float((prog.double() - ref.double()).norm() / ref.double().norm())


def bf16_unit(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length in float32 and rounded to bf16: the
    configuration's precision for the features the class head scores."""
    xf = x.float()
    return (xf / xf.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(torch.bfloat16)


def _top2(x: torch.Tensor):
    v, i = torch.topk(x, min(2, x.shape[1]), dim=1)
    second = v[:, 1] if v.shape[1] > 1 else torch.full_like(v[:, 0], -np.inf)
    return i[:, 0], v[:, 0], second


def _path_point(match: torch.Tensor, L: int):
    """Per row (path, point) of a chain of length L from [B, L] matches."""
    mf = match.double()
    point = mf.sum(dim=1) / L
    if L == 1:
        return mf[:, 0], point
    path = (match[:, :-1] & match[:, 1:]).double().sum(dim=1) / (L - 1)
    return path, point


def eval_metric_range(feats: torch.Tensor, bank: torch.Tensor, target: int,
                      path: Sequence[int], depth: torch.Tensor, test_mask: torch.Tensor,
                      eps: float = 2e-5) -> Dict[str, np.ndarray]:
    """The reference's metric sums for one single-class batch, worked out in
    float64 from the batch's features [B, D] and the bank [N, D] of real
    classes in class order: flat Hit@k over the unseen classes, TOR (the
    best class anywhere in the target's root path) and path and point
    ratios (each root-path level's best class against the path's node).
    A decision whose two sides lie within ``eps`` counts either way, so
    each sum comes as ``lo`` and ``hi``."""
    f = bf16_unit(feats).double()
    lg = f @ bank.double().T                                         # [B, N]
    B = lg.shape[0]
    t = lg[:, target]
    test = test_mask[None, :]
    gt = ((lg > (t + eps)[:, None]) & test).sum(dim=1)
    ge = ((lg >= (t - eps)[:, None]) & test).sum(dim=1) - 1          # rank range [gt, ge]
    ks = torch.tensor(TOPK, device=lg.device)[None, :]
    hit_lo = (ge[:, None] < ks).double().sum(dim=0)
    hit_hi = (gt[:, None] < ks).double().sum(dim=0)

    chain = torch.tensor(list(path), device=lg.device)
    i1, v1, v2 = _top2(lg)
    amb = (v1 - v2) <= eps
    tor_hit = (i1[:, None] == chain[None, :]).any(dim=1)
    tor_lo = (tor_hit & ~amb).double().sum()
    tor_hi = (tor_hit | amb).double().sum()

    sure = torch.zeros((B, len(path)), dtype=torch.bool, device=lg.device)
    maybe = torch.zeros_like(sure)
    for j, node in enumerate(path):
        cols = torch.nonzero(depth == depth[node])[:, 0]
        i1, v1, v2 = _top2(lg[:, cols])
        m = cols[i1] == node
        a = (v1 - v2) <= eps
        sure[:, j] = m & ~a
        maybe[:, j] = m | a
    path_lo, point_lo = _path_point(sure, len(path))
    path_hi, point_hi = _path_point(maybe, len(path))
    out = {
        "hits": (hit_lo, hit_hi),
        "tor": (tor_lo, tor_hi),
        "path": (path_lo.sum(), path_hi.sum()),
        "point": (point_lo.sum(), point_hi.sum()),
        "num": (torch.tensor(float(B)), torch.tensor(float(B))),
    }
    return {k: (np.atleast_1d(lo.cpu().numpy()), np.atleast_1d(hi.cpu().numpy()))
            for k, (lo, hi) in out.items()}


def metric_excess(prog: Dict[str, np.ndarray], ranges: Dict[str, tuple],
                  tol: float = 1e-3) -> float:
    """How far any of the program's sums lies outside the reference's range
    (``tol`` covers float32 sums of fractions); 0 when all lie inside."""
    worst = 0.0
    for k, (lo, hi) in ranges.items():
        v = np.atleast_1d(np.asarray(prog[k], dtype=np.float64))
        worst = max(worst, float(np.max(np.maximum(lo - tol - v, v - hi - tol))))
    return max(worst, 0.0)


def within(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limit's number read, finite, and at or under it."""
    return all(k in checks and np.isfinite(checks[k]) and checks[k] <= v
               for k, v in limits.items())


def over(checks: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """The numbers read that are over their limits, or not finite: the
    control's verdict, which rests on the numbers it reads alone."""
    return [k for k, v in checks.items()
            if k in limits and not (np.isfinite(v) and v <= limits[k])]


def ref_logits(feats: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Cosine logits of unnormalised features against unit bank rows."""
    return normalize(feats.double()) @ bank.double().T
