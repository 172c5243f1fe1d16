"""Everything a run feeds the program and the reference, made from ``--seed``.

The hierarchy generator and the prompt convention are copies of the
program's (``profiled_edges`` and ``synthetic_tokens``), kept here so that
the yardstick does not move when the program does. The reference derives
depths, chains and prompts from these functions, never from the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ROOT = "fall11"


def stream(seed: int, *tags: int) -> np.random.Generator:
    """An independent numpy stream for one purpose of one run."""
    return np.random.default_rng([seed % 2**63, *tags])


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, derived like :func:`stream`."""
    return int(stream(seed, *tags).integers(0, 2**63 - 1))


# ---------------------------------------------------------------------------
# hierarchy: a copy of the program's profiled_edges, and the tables the
# reference needs, worked out from the edges themselves
# ---------------------------------------------------------------------------


def profiled_edges(level_sizes: Sequence[int], seed: int = 0, cross_edges: int = 0,
                   root: str = ROOT) -> List[Tuple[str, str]]:
    """Edges of a DAG with a prescribed node count per depth: each node at
    depth d draws a parent at depth d-1 (``hierarchy/tree.py`` of the
    program, copied)."""
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


class Tree:
    """Node order, depth and root path of a tree's edge list (one parent per
    node), as the reference reads them: nodes in order of first appearance
    with the root left out, depth 0 for the root's children."""

    def __init__(self, edges: Sequence[Tuple[str, str]], root: str = ROOT):
        order: List[str] = []
        seen = set()
        parent: Dict[str, str] = {}
        for u, v in edges:
            for n in (u, v):
                if n not in seen:
                    seen.add(n)
                    order.append(n)
            if v in parent:
                raise ValueError(f"{v} has two parents: the reference takes trees only")
            parent[v] = u
        self.names = [n for n in order if n != root]
        ids = {n: i for i, n in enumerate(self.names)}
        self.parent = np.asarray([ids.get(parent[n], -1) for n in self.names], np.int64)
        n = len(self.names)
        self.depth = np.zeros(n, np.int64)
        for i in range(n):  # parents come before children in the edge list
            p = self.parent[i]
            self.depth[i] = 0 if p < 0 else self.depth[p] + 1

    @property
    def num_nodes(self) -> int:
        return len(self.names)

    def path(self, node: int) -> List[int]:
        """Root child .. node."""
        out = [int(node)]
        while self.parent[out[-1]] >= 0:
            out.append(int(self.parent[out[-1]]))
        return out[::-1]

    def depth_order(self) -> np.ndarray:
        """Node ids by depth, ties by id; an n_pad list puts pads last."""
        return np.argsort(self.depth, kind="stable")


def split_unseen(num_nodes: int, seed: int, n_seen: int) -> np.ndarray:
    """Sorted ids of the unseen classes: all but ``n_seen`` of a seeded
    permutation."""
    perm = stream(seed, 11).permutation(num_nodes)
    return np.sort(perm[n_seen:])


# ---------------------------------------------------------------------------
# prompts: the program's synthetic_tokens convention, copied
# ---------------------------------------------------------------------------


def synthetic_tokens(n: int, context_length: int, vocab_size: int, seed: int,
                     max_body: int = 18) -> np.ndarray:
    """SOT + 4..max_body ids + EOT, zero-padded to the context length
    (``tree_model.synthetic_tokens`` of the program, copied)."""
    rng = np.random.default_rng(seed)
    max_body = min(max_body, context_length - 3)
    toks = np.zeros((n, context_length), np.int32)
    toks[:, 0] = vocab_size - 2
    lens = rng.integers(4, max_body + 1, size=n)
    body = rng.integers(1, vocab_size - 2, size=(n, max_body))
    cols = np.arange(max_body)[None, :]
    toks[:, 1: 1 + max_body] = np.where(cols < lens[:, None], body, 0)
    toks[np.arange(n), 1 + lens] = vocab_size - 1
    return toks


def prompt_lengths(tokens: np.ndarray) -> np.ndarray:
    """Tokens through EOT (the largest id) of each prompt."""
    return tokens.argmax(axis=1).astype(np.int64) + 1


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def images(n: int, resolution: int, seed: int, tag: int, device, shift: float = 0.0,
           group: int = 1) -> np.ndarray:
    """``n`` uint8 NHWC images on the host: noise at three scales (7, 28 and
    full resolution) under a contrast and a colour cast of each image's own,
    so that images, and their features and gradients, differ from row to
    row. With ``shift``, the first half of every ``group`` images is
    lighter by ``shift`` and the second half darker by it, so that the two
    halves of a batch of ``group`` differ. Drawn on ``device`` in a few
    calls, then copied to the host."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 21, tag))
    out = torch.zeros((n, 3, resolution, resolution), device=device)
    for cells, amp in ((7, 60.0), (28, 35.0), (resolution, 20.0)):
        z = torch.randn((n, 3, cells, cells), generator=g, device=device) * amp
        out += torch.nn.functional.interpolate(z, size=(resolution, resolution),
                                               mode="bilinear", align_corners=False)
    contrast = 0.3 + 1.4 * torch.rand((n, 1, 1, 1), generator=g, device=device)
    cast = 40.0 * torch.randn((n, 3, 1, 1), generator=g, device=device)
    light = torch.arange(n, device=device) % group < group // 2
    shift_t = torch.where(light, shift, -shift).reshape(n, 1, 1, 1)
    out = (out * contrast + 128.0 + cast + shift_t).clamp_(0, 255).round_().to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous().cpu().numpy()
