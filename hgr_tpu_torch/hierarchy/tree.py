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
the root chosen by networkx" (``utils.py:55``); we call networkx
``shortest_path`` itself when available (``_nx_chains``) because its
bidirectional-BFS tie-breaks differ from a forward BFS on some multi-parent
DAGs — a divergence the executed-reference oracle caught (docs/PARITY.md
tier-1 table). The forward edge-insertion-order BFS remains only as the
networkx-unavailable fallback; both satisfy the parent-linkage invariant the
reference asserts (``utils.py:58-64``).
"""

from __future__ import annotations

import json
from collections import deque
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
    @staticmethod
    def _nx_chains(edges, names, name_to_id, root):
        """Root-exclusive ancestor chains via networkx ``shortest_path`` —
        the reference's literal call (``utils.py:55``). Returns None when
        networkx is unavailable (caller falls back to forward BFS)."""
        try:
            import networkx as nx
        except ImportError:
            return None
        G = nx.DiGraph()
        G.add_edges_from(edges)
        chains: List[List[int]] = []
        try:
            for n in names:
                path = nx.shortest_path(G, source=root, target=n)[1:-1]
                chains.append([name_to_id[p] for p in path])
        except nx.NetworkXNoPath as e:
            raise ValueError(f"node unreachable from root: {e}") from e
        return chains

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

        # Canonical root->node chain. The reference defines it as networkx
        # ``shortest_path`` (``utils.py:55``), whose bidirectional-BFS
        # tie-breaking differs from a plain forward BFS when several
        # shortest paths exist (observed: an executed-reference oracle run
        # diverged on a multi-parent node with two equal-length paths). Use
        # networkx itself when available so the choice is identical BY
        # CONSTRUCTION; fall back to forward-BFS first-predecessor order.
        chains = cls._nx_chains(edges, names, name_to_id, root)
        if chains is None:
            parent: Dict[str, str] = {root: root}
            dist: Dict[str, int] = {root: 0}
            q = deque([root])
            while q:
                u = q.popleft()
                for v in succ[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        parent[v] = u
                        q.append(v)

            unreachable = [n for n in names if n not in dist]
            if unreachable:
                raise ValueError(
                    f"{len(unreachable)} nodes unreachable from root, "
                    f"e.g. {unreachable[:5]}"
                )

            chains = []
            for n in names:
                path: List[str] = []
                cur = n
                while parent[cur] != root:
                    cur = parent[cur]
                    path.append(cur)
                path.reverse()
                chains.append([name_to_id[p] for p in path])

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
    return Hierarchy.from_edges(edges, root=root)


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
