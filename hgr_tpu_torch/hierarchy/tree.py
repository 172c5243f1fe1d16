"""Hierarchy core: WordNet-style DAG -> padded integer tables.

The port's own copy of ``hgr_tpu/hierarchy/tree.py`` (numpy only). It
replaces the reference's runtime hierarchy tables (reference
``utils.py:39-72`` ``gen_tree`` -> ``p2c, c2p, d2n, nodes, start_up``) with
**static-shape numpy arrays** that can be copied to the device once and
consumed by gathers and masked argmaxes without host round-trips:

- ``depth[N]``           int32, depth of each node (root children = 0, as in the
                         reference where ``depth = len(c2p)``)
- ``ancestors[N, D]``    int32, canonical root->parent ancestor chain per node,
                         padded with -1 (replaces ``c2p``)
- ``child_indptr/child_indices``  CSR children lists (replaces ``p2c``)
- ``level_members[L, M]`` int32 padded node-id lists per depth (replaces ``d2n``)
- ``root_children``      int32 ids of the virtual root's children (``start_up``)

Ordering parity: the reference's node ordering is networkx insertion order over
the edge list with the virtual root removed (``utils.py:44-46``); we reproduce
that exactly. The reference's canonical ancestor chain is "a shortest path from
the root chosen by networkx" (``utils.py:55``), and where a node has several
shortest paths, networkx's bidirectional BFS picks one that a forward BFS does
not (docs/PARITY.md tier-1 table). The port therefore carries its own copy of
that search (``_bidirectional_path``) and uses it always, so its chains are
the JAX package's with networkx on every machine, networkx installed or not.
Every chain satisfies the parent-linkage invariant the reference asserts
(``utils.py:58-64``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

ROOT = "fall11"  # virtual root wnid used by the reference's edge lists
PAD = -1


@dataclass
class Hierarchy:
    """Immutable padded-array view of a class DAG (root excluded)."""

    names: List[str]                 # wnid per node id, reference node ordering
    depth: np.ndarray                # [N] int32
    ancestors: np.ndarray            # [N, D] int32, PAD-filled; chain root-child..parent
    child_indptr: np.ndarray         # [N+1] int32
    child_indices: np.ndarray        # [E] int32
    level_members: np.ndarray        # [L, M] int32, PAD-filled
    level_sizes: np.ndarray          # [L] int32
    root_children: np.ndarray        # [R] int32
    name_to_id: Dict[str, int] = field(repr=False, default_factory=dict)

    # ---- derived scalars -------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.names)

    @property
    def max_depth(self) -> int:
        """Deepest populated level (== max key of the reference's ``d2n``)."""
        return int(self.depth.max())

    @property
    def max_chain(self) -> int:
        """Longest root->parent chain; ``ancestors.shape[1]``."""
        return int(self.ancestors.shape[1])

    # ---- list-form accessors (parity with the reference's tables) -------
    def chain(self, node: int) -> List[int]:
        """Ancestor chain of ``node`` (root-child .. parent), reference ``c2p[i]``."""
        d = int(self.depth[node])
        return [int(x) for x in self.ancestors[node, :d]]

    def chain_with_self(self, node: int) -> List[int]:
        """``c2p[target] + [target]`` as used by the OM loss and eval."""
        return self.chain(node) + [int(node)]

    def children(self, node: int) -> List[int]:
        lo, hi = int(self.child_indptr[node]), int(self.child_indptr[node + 1])
        return [int(x) for x in self.child_indices[lo:hi]]

    def level(self, d: int) -> List[int]:
        n = int(self.level_sizes[d])
        return [int(x) for x in self.level_members[d, :n]]

    def ids(self, names: Sequence[str]) -> np.ndarray:
        return np.asarray([self.name_to_id[n] for n in names], dtype=np.int32)

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_edges(cls, edges: Sequence[Tuple[str, str]], root: str = ROOT) -> "Hierarchy":
        """Build from an edge list ``[(parent, child), ...]`` containing ``root``.

        Node ordering, the child adjacency order, and the BFS tie-breaking all
        follow edge-insertion order, mirroring networkx ``DiGraph`` semantics
        that the reference relies on (``utils.py:41-46``).
        """
        order: List[str] = []
        seen = set()
        succ: Dict[str, List[str]] = {}

        def _touch(n: str) -> None:
            if n not in seen:
                seen.add(n)
                order.append(n)
                succ[n] = []

        for u, v in edges:
            _touch(u)
            _touch(v)
            succ[u].append(v)

        if root not in seen:
            raise ValueError(f"root {root!r} not present in edge list")

        names = [n for n in order if n != root]
        name_to_id = {n: i for i, n in enumerate(names)}
        n_nodes = len(names)

        # Canonical root->node chain: networkx ``shortest_path``'s choice
        # (``utils.py:55``), whose adjacency is DiGraph's: each neighbour
        # once, in the order its first edge was added
        dsucc: Dict[str, Dict[str, None]] = {n: {} for n in order}
        dpred: Dict[str, Dict[str, None]] = {n: {} for n in order}
        for u, v in edges:
            dsucc[u][v] = None
            dpred[v][u] = None
        chains = []
        for n in names:
            path = _bidirectional_path(dsucc, dpred, root, n)
            chains.append([name_to_id[p] for p in path[1:-1]])

        depth = np.asarray([len(c) for c in chains], dtype=np.int32)
        max_chain = max(1, int(depth.max()))
        ancestors = np.full((n_nodes, max_chain), PAD, dtype=np.int32)
        for i, c in enumerate(chains):
            ancestors[i, : len(c)] = c

        # Parent-linkage invariant (reference utils.py:58-64): every consecutive
        # pair in a chain must be an actual edge.
        child_sets = {i: set() for i in range(n_nodes)}
        indptr = np.zeros(n_nodes + 1, dtype=np.int32)
        flat_children: List[int] = []
        for i, n in enumerate(names):
            kids = [name_to_id[c] for c in succ[n]]
            child_sets[i].update(kids)
            flat_children.extend(kids)
            indptr[i + 1] = len(flat_children)
        for i, c in enumerate(chains):
            full = c + [i]
            for a, b in zip(full[:-1], full[1:]):
                assert b in child_sets[a], (
                    f"chain of node {names[i]} not parent-linked at ({a},{b})"
                )

        levels: Dict[int, List[int]] = {}
        for i in range(n_nodes):
            levels.setdefault(int(depth[i]), []).append(i)
        n_levels = max(levels) + 1
        max_level = max(len(v) for v in levels.values())
        level_members = np.full((n_levels, max_level), PAD, dtype=np.int32)
        level_sizes = np.zeros(n_levels, dtype=np.int32)
        for d, members in levels.items():
            level_members[d, : len(members)] = members
            level_sizes[d] = len(members)

        root_children = np.asarray(
            [name_to_id[c] for c in succ[root]], dtype=np.int32
        )

        return cls(
            names=names,
            depth=depth,
            ancestors=ancestors,
            child_indptr=indptr,
            child_indices=np.asarray(flat_children, dtype=np.int32),
            level_members=level_members,
            level_sizes=level_sizes,
            root_children=root_children,
            name_to_id=name_to_id,
        )

    @classmethod
    def from_json(cls, path: str, root: str = ROOT) -> "Hierarchy":
        """Load from the reference's ``graph_edges_cls.json`` edge-list schema."""
        with open(path) as f:
            edges = json.load(f)
        return cls.from_edges([tuple(e) for e in edges], root=root)


def _bidirectional_path(succ, pred, source: str, target: str) -> List[str]:
    """A shortest ``source`` -> ``target`` path, the one networkx's unweighted
    ``bidirectional_shortest_path`` returns (networkx 3.x,
    ``algorithms/shortest_paths/unweighted.py``, ``_bidirectional_pred_succ``;
    BSD licence): two BFS fringes, the smaller expanded first and the forward
    one on a tie, each neighbour list walked in order; the path is joined at
    the first node either search finds in the other's visited set."""
    if source == target:
        return [source]
    fwd = {source: None}  # node -> its predecessor towards source
    rev = {target: None}  # node -> its successor towards target
    forward, reverse = [source], [target]
    meet = None
    while forward and reverse and meet is None:
        if len(forward) <= len(reverse):
            level, forward = forward, []
            for v in level:
                for w in succ[v]:
                    if w not in fwd:
                        forward.append(w)
                        fwd[w] = v
                    if w in rev:
                        meet = w
                        break
                if meet is not None:
                    break
        else:
            level, reverse = reverse, []
            for v in level:
                for w in pred[v]:
                    if w not in rev:
                        rev[w] = v
                        reverse.append(w)
                    if w in fwd:
                        meet = w
                        break
                if meet is not None:
                    break
    if meet is None:
        raise ValueError(f"node unreachable from root: no path from {source} to {target}")
    path: List[str] = []
    w = meet
    while w is not None:
        path.append(w)
        w = fwd[w]
    path.reverse()
    w = rev[meet]
    while w is not None:
        path.append(w)
        w = rev[w]
    return path


def profiled_edges(
    level_sizes: Sequence[int],
    seed: int = 0,
    cross_edges: int = 0,
    root: str = ROOT,
) -> List[Tuple[str, str]]:
    """The edge list of :func:`profiled_hierarchy`, in its order (what a
    ``graph_edges_cls.json`` of that hierarchy holds)."""
    rng = np.random.default_rng(seed)
    edges: List[Tuple[str, str]] = []
    prev = [root]
    by_level: List[List[str]] = []
    counter = 0
    for size in level_sizes:
        cur: List[str] = []
        for _ in range(int(size)):
            name = f"n{counter:08d}"
            counter += 1
            edges.append((prev[int(rng.integers(len(prev)))], name))
            cur.append(name)
        by_level.append(cur)
        prev = cur
    for _ in range(cross_edges):
        lvl = int(rng.integers(0, len(by_level) - 1))
        u = by_level[lvl][int(rng.integers(len(by_level[lvl])))]
        v = by_level[lvl + 1][int(rng.integers(len(by_level[lvl + 1])))]
        if (u, v) not in edges:
            edges.append((u, v))
    return edges


def profiled_hierarchy(
    level_sizes: Sequence[int],
    seed: int = 0,
    cross_edges: int = 0,
    root: str = ROOT,
) -> Hierarchy:
    """Synthetic DAG with a PRESCRIBED per-depth node count.

    Used to reproduce the reference deployment's class geometry — 18,278
    nodes over 13 uneven levels (supp Table 1/3; pinned counts at
    ``data/train_test_split_backup.py:86-89``) — so sharded-eval equality
    can be proven where shard boundaries split levels mid-way. Each node at
    depth d draws a random parent at depth d-1; ``cross_edges`` adds
    multi-parent links (one level down) like real WordNet.
    """
    return Hierarchy.from_edges(profiled_edges(level_sizes, seed, cross_edges, root), root=root)


def synthetic_hierarchy(
    branching: int = 3,
    levels: int = 4,
    extra_edges: int = 5,
    seed: int = 0,
    root: str = ROOT,
) -> Hierarchy:
    """Deterministic synthetic DAG for tests/benchmarks.

    A ``branching``-ary tree of ``levels`` levels plus ``extra_edges`` random
    cross-links (to a node one level deeper, creating multi-parent nodes like
    real WordNet).
    """
    rng = np.random.default_rng(seed)
    edges: List[Tuple[str, str]] = []
    by_level: List[List[str]] = [[root]]
    counter = 0
    for lvl in range(levels):
        cur: List[str] = []
        for p in by_level[-1]:
            for _ in range(branching):
                child = f"n{counter:08d}"
                counter += 1
                edges.append((p, child))
                cur.append(child)
        by_level.append(cur)
    for _ in range(extra_edges):
        lvl = int(rng.integers(1, levels))
        u = by_level[lvl][int(rng.integers(len(by_level[lvl])))]
        v = by_level[lvl + 1][int(rng.integers(len(by_level[lvl + 1])))]
        if (u, v) not in edges:
            edges.append((u, v))
    return Hierarchy.from_edges(edges, root=root)
