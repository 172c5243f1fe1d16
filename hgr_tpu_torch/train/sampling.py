"""Negative sampling + OM pair-schedule construction, on the host (the
port's own copy of ``hgr_tpu/train/sampling.py:57-393``; numpy only).

The reference's ``get_contra`` (``model/clip_tree.py:80-196``) runs inside
the training loop, one Python call per (outer, inner) loop step. Here all
sampling for a batch happens up front, producing a fixed-shape **pair
schedule** that the train step consumes:

- ``compare   [P, C]``  candidate class ids per pair (C = num_compare + 1)
- ``compare_valid [P, C]`` slot mask (sets smaller than C are padded)
- ``label     [P]``     position of the positive within each compare set
- ``in_pos/in_len/out_pos/out_len [P]`` weight-lookup coordinates
  (positions within the TRUNCATED inner/outer loops, as the reference indexes
  ``weights_in[m_loop]``/``weights_out[k_loop]`` over the truncated lists,
  ``model/clip_tree.py:229-276``)
- ``pair_valid [P]``    pair mask (schedules shorter than P_max are padded)
- ``unique    [U]`` + ``inv [P, C]`` de-duplicated class ids to text-encode
  once per step plus the gather map back to pairs (the reference re-encodes
  the same prompts for every pair; the gradients are the same)

Sampling strategies (reference semantics, same names):

- ``random``   uniform sample of candidate classes (``:81-91``)
- ``simi``     most text-similar classes, excluding ancestors and children
               (``:93-113``; NB the reference passes a python list of ids to
               ``encode_text`` there, which cannot run — rebuilt here against
               a cached class-feature bank, refreshed by the trainer)
- ``topk``     classes within the k-layer window BELOW the anchor depth,
               minus ancestors (``:116-141``) — the paper default
- ``near_simi`` k-layer window both sides, ranked by text similarity
               (``:144-178``; also dead as written upstream — the [1, M]
               argsort is sliced on the wrong axis and the ragged id list
               crashes ``torch.tensor``, ``:170-176``; rebuilt)
- ``brothers`` siblings via the parent's child list, root level uses the
               root's children (``:180-196``)

The positive class is appended when absent, and the label is its index —
matching ``compare_idx.append(target)`` + position-of-target labels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..hierarchy import Hierarchy

STRATEGIES = ("random", "simi", "topk", "near_simi", "brothers")


@dataclass
class PairSchedule:
    """Static-shape device-ready schedule for one training batch."""

    compare: np.ndarray        # [P, C] int32
    compare_valid: np.ndarray  # [P, C] bool
    label: np.ndarray          # [P] int32
    in_pos: np.ndarray         # [P] int32
    in_len: np.ndarray         # [P] int32
    out_pos: np.ndarray        # [P] int32
    out_len: np.ndarray        # [P] int32
    pair_valid: np.ndarray     # [P] bool
    unique: np.ndarray         # [U] int32 (padded)
    inv: np.ndarray            # [P, C] int32 indices into unique


def _ceil_ratio(ratio: float, n: int) -> int:
    k = math.ceil(ratio * n)
    return max(k, 1)


class NegativeSampler:
    """Host-side sampler over a :class:`Hierarchy`."""

    def __init__(
        self,
        hier: Hierarchy,
        train_index: np.ndarray,
        num_compare: int,
        k: int = 1,
        seed: int = 0,
        class_feats: Optional[np.ndarray] = None,  # [N, D] for simi ranking
        topk_window: str = "below",  # "below" = clip_tree.py:127-131;
        # "both" = the tree_coop variant's symmetric window
        # (model/clip_coop.py:101-106)
        exclu_bro: bool = False,     # also exclude siblings
        # (model/clip_coop.py:111-115)
    ):
        self.hier = hier
        self.train_index = np.asarray(train_index, np.int64)
        self.train_set = set(int(x) for x in self.train_index)
        self.num_compare = num_compare
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.class_feats = class_feats
        self.topk_window = topk_window
        self.exclu_bro = exclu_bro
        # level -> candidate list caches
        self._level_lists: Dict[int, List[int]] = {
            d: hier.level(d) for d in range(hier.max_depth + 1)
        }
        self._level_arrays: Dict[int, np.ndarray] = {
            d: np.asarray(v, np.int64) for d, v in self._level_lists.items()
        }
        # similarity-ranking caches (see _top_by_similarity): at reference
        # scale a fresh rank costs one [N, D] matvec + argpartition; the OM
        # inner loop re-asks the SAME (target, window) many times per
        # schedule and popular ancestors recur across batches
        self._sims_target: Optional[int] = None
        self._sims: Optional[np.ndarray] = None
        self._rank_cache: Dict[tuple, List[int]] = {}

    def set_class_feats(self, feats: np.ndarray) -> None:
        """Refresh the cached text-feature bank used by simi/near_simi."""
        self.class_feats = np.asarray(feats, np.float32)
        self._sims_target = None
        self._sims = None
        self._rank_cache.clear()

    # ---- strategies ------------------------------------------------------
    def sample(
        self,
        method: str,
        target: int,
        depth: int,
        parents: Sequence[int],
    ) -> Tuple[List[int], int]:
        """-> (compare ids, label position of target)."""
        if method == "random":
            ids = list(
                self.rng.choice(
                    self.train_index, size=self.num_compare, replace=False
                )
            )
            ids = [int(x) for x in ids]
        elif method == "simi":
            excl = set(parents) | set(self.hier.children(target))
            if self.class_feats is None:
                cand = [c for c in self.train_set if c not in excl]
                ids = self._rank_by_similarity(target, cand)[: self.num_compare]
            else:
                # excl depends only on target (its chain + children), so the
                # ranked result is cacheable per target; ranking the full
                # train pool then dropping excl equals the reference's
                # filter-then-rank (same candidate set, same scores)
                key = ("simi", int(target))
                ids = self._rank_cache.get(key)
                if ids is None:
                    ids = self._top_by_similarity(
                        target, self.train_index, excl
                    )
                    self._rank_cache[key] = ids
                ids = list(ids)
        elif method == "topk":
            low = max(0, depth - self.k)
            cand: List[int] = []
            if self.topk_window == "both":
                high = min(self.hier.max_depth, depth + self.k)
                for d in range(low, high + 1):
                    cand.extend(self._level_lists[d])
            else:
                for d in range(low, depth):
                    cand.extend(self._level_lists[d])
                if depth == 0:
                    cand.extend(self._level_lists[0])
            pool_set = set(cand) - set(parents)
            if self.exclu_bro and len(parents) > 1 and depth > 0:
                parent = parents[depth - 1]
                pool_set -= set(self.hier.children(parent)) - {target}
            pool = list(pool_set)
            if len(pool) > self.num_compare:
                idx = self.rng.choice(len(pool), self.num_compare, replace=False)
                ids = [pool[i] for i in idx]
            else:
                ids = pool
        elif method == "near_simi":
            low = max(0, depth - self.k)
            high = min(self.hier.max_depth, depth + self.k)
            excl = set(parents) | set(self.hier.children(target))
            if self.class_feats is None:
                cand = []
                for d in range(low, high + 1):
                    cand.extend(self._level_lists[d])
                pool = [c for c in set(cand) if c not in excl]
                ids = self._rank_by_similarity(target, pool)[: self.num_compare]
            else:
                key = ("near_simi", int(target), low, high)
                ids = self._rank_cache.get(key)
                if ids is None:
                    cand = np.concatenate(
                        [self._level_arrays[d] for d in range(low, high + 1)]
                    )
                    ids = self._top_by_similarity(target, cand, excl)
                    self._rank_cache[key] = ids
                ids = list(ids)
        elif method == "brothers":
            if len(parents) > 1 and depth > 0:
                parent = parents[depth - 1]
                pool = list(self.hier.children(parent))
            else:
                pool = [int(x) for x in self.hier.root_children]
            if len(pool) > self.num_compare:
                idx = self.rng.choice(len(pool), self.num_compare, replace=False)
                ids = [pool[i] for i in idx]
            else:
                ids = list(pool)
        else:
            raise ValueError(
                f"unknown sample strategy {method!r}; options {STRATEGIES}"
            )

        if target not in ids:
            ids.append(int(target))
        return ids, ids.index(int(target))

    def _top_by_similarity(
        self, target: int, cand: np.ndarray, excl: set
    ) -> List[int]:
        """Top ``num_compare`` most-similar candidate ids, ``excl`` dropped.

        O(N) per fresh target instead of a per-pair python-set pool and a
        full argsort: one cached [N, D] @ [D] matvec per target,
        ``argpartition`` for the top slice, exclusion applied to the ranked
        prefix (equivalent to pre-filtering: excl scores cannot displace
        non-excl ranks).
        """
        f = self.class_feats
        if self._sims_target != int(target):
            self._sims = f @ f[int(target)]
            self._sims_target = int(target)
        sims = self._sims[cand]
        # enough slots that dropping every excluded id still leaves a full set
        need = min(len(cand), self.num_compare + len(excl))
        if need < len(cand):
            # argpartition picks an ARBITRARY member among ties that
            # straddle the need-boundary (exact ties happen: duplicate
            # lemma prompts give bit-identical embeddings); rebuild the
            # prefix as "all strictly above the kth value, then the
            # lowest-index ties" so the selected SET matches the stable
            # full-sort path exactly
            kth = sims[np.argpartition(-sims, need - 1)[need - 1]]
            hi = np.flatnonzero(sims > kth)
            ties = np.flatnonzero(sims == kth)[: need - len(hi)]
            part = np.concatenate([hi, ties])
            part = part[np.argsort(-sims[part], kind="stable")]
        else:
            part = np.argsort(-sims, kind="stable")
        out: List[int] = []
        for i in part:
            c = int(cand[i])
            if c not in excl:
                out.append(c)
                if len(out) == self.num_compare:
                    break
        return out

    def _rank_by_similarity(self, target: int, pool: List[int]) -> List[int]:
        if self.class_feats is None or not pool:
            # no feature bank yet: fall back to a random subset
            pool = list(pool)
            self.rng.shuffle(pool)
            return pool
        f = self.class_feats
        t = f[target]
        sims = f[np.asarray(pool)] @ t
        order = np.argsort(-sims, kind="stable")
        return [pool[i] for i in order]


def max_pairs(hier: Hierarchy, out_ratio: float, in_ratio: float) -> int:
    """Static upper bound on pairs per batch (the step's fixed P): the OM loop
    visits ceil(out_ratio*L) outer nodes x ceil(in_ratio*L') inner nodes."""
    best = 1
    for t in range(hier.num_nodes):
        parents = hier.chain_with_self(t)
        kk = _ceil_ratio(out_ratio, len(parents))
        total = 0
        for p_out in list(reversed(parents))[:kk]:
            l_in = len(hier.chain_with_self(p_out))
            total += _ceil_ratio(in_ratio, l_in)
        best = max(best, total)
    return best


def _pad_schedule(
    rows: List[Tuple[List[int], int, int, int, int, int]],
    p_max: int,
    c_max: int,
    u_bucket: int,
) -> PairSchedule:
    P = p_max
    compare = np.zeros((P, c_max), np.int32)
    compare_valid = np.zeros((P, c_max), bool)
    label = np.zeros(P, np.int32)
    in_pos = np.zeros(P, np.int32)
    in_len = np.ones(P, np.int32)
    out_pos = np.zeros(P, np.int32)
    out_len = np.ones(P, np.int32)
    pair_valid = np.zeros(P, bool)
    for i, (ids, lab, ip, il, op, ol) in enumerate(rows):
        n = len(ids)
        compare[i, :n] = ids
        compare_valid[i, :n] = True
        label[i] = lab
        in_pos[i], in_len[i], out_pos[i], out_len[i] = ip, il, op, ol
        pair_valid[i] = True

    uniq, inv_flat = np.unique(compare, return_inverse=True)
    u = len(uniq)
    if u_bucket < u:
        u_bucket = ((u + 255) // 256) * 256
    unique = np.zeros(u_bucket, np.int32)
    unique[:u] = uniq
    inv = inv_flat.reshape(P, c_max).astype(np.int32)
    return PairSchedule(
        compare=compare,
        compare_valid=compare_valid,
        label=label,
        in_pos=in_pos,
        in_len=in_len,
        out_pos=out_pos,
        out_len=out_len,
        pair_valid=pair_valid,
        unique=unique,
        inv=inv,
    )


class ScheduleBuilder:
    """Builds the per-batch pair schedule for OM / hierarchical training
    (the data-side restructuring of ``train_batch``,
    ``model/clip_tree.py:222-316``)."""

    def __init__(
        self,
        hier: Hierarchy,
        sampler: NegativeSampler,
        out_ratio: float,
        in_ratio: float,
        num_compare: int,
        method: str = "OM",
        strategy: str = "topk",
        u_bucket: int = 256,
    ):
        self.hier = hier
        self.sampler = sampler
        self.out_ratio = out_ratio
        self.in_ratio = in_ratio
        self.c_max = num_compare + 1
        self.method = method
        self.strategy = strategy
        self.u_bucket = u_bucket
        if method == "OM":
            self.p_max = max_pairs(hier, out_ratio, in_ratio)
        elif method == "hierarchical":
            self.p_max = hier.max_chain + 1
        else:
            raise ValueError(
                f"training_method {method!r} not supported (reference also "
                "accepts 'flat' but leaves it unimplemented, main.py:55)"
            )

    def build(self, target: int) -> PairSchedule:
        rows: List[Tuple[List[int], int, int, int, int, int]] = []
        if self.method == "OM":
            parents = self.hier.chain_with_self(target)
            kk = _ceil_ratio(self.out_ratio, len(parents))
            outer = list(reversed(parents))[:kk]
            for k_loop, p_out in enumerate(outer):
                parents_in = self.hier.chain_with_self(p_out)
                mm = _ceil_ratio(self.in_ratio, len(parents_in))
                inner = list(reversed(parents_in))[:mm]
                for m_loop, p_in in enumerate(inner):
                    depth = parents_in.index(p_in)
                    ids, lab = self.sampler.sample(
                        self.strategy, p_out, depth, parents_in
                    )
                    rows.append((ids, lab, m_loop, mm, k_loop, kk))
        else:  # hierarchical (model/clip_tree.py:283-316)
            parents = self.hier.chain_with_self(target)
            L = len(parents)
            for j, _p in enumerate(parents):
                ids, lab = self.sampler.sample(
                    self.strategy, target, j, parents
                )
                rows.append((ids, lab, j, L, 0, 1))
        return _pad_schedule(rows, self.p_max, self.c_max, self.u_bucket)
