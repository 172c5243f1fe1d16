"""DGP / SGCN baseline family: GCN regression from class embeddings to
classifier weights (port of ``hgr_tpu/baselines/gcn.py``).

The reference's GCN variants (``baseline/DGP/models/gcn.py:42-88``,
``models/gcn_dense.py:84-92``, ``models/gcn_dense_att.py:31-116``) and its
two-stage pipeline (``train_gcn_dense_att.py``, ``evaluate_imagenet.py``):

stage A  regress class embeddings through a GCN over the WordNet DAG onto
         the normalised fc rows of a classifier for the seen classes
         (masked L2 loss, Adam, full-graph epochs);
stage B  score features (+ a bias column) against ALL predicted
         classifiers, then the shared hierarchical metrics.

Each adjacency is an edge list with in-degree normalisation (``normt_spm
('in')``: the mean over a receiver's predecessors); aggregation is a gather
and an ``index_add_``, the JAX package's ``segment_sum``. On the card
``index_add_`` sums in no fixed order, so results there agree within a
tolerance, not bitwise. Modes: ``basic`` (one adjacency, SGCN), ``dense``
(ancestor and descendant sides alternating per layer), ``dense_att``
(per-hop adjacencies with a learned softmax over hops on each side).
Dropout masks are passed in (``draw_dropout_masks`` draws them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .optim import Adam, from_numpy, grads, tree_leaves

Edges = np.ndarray  # [E, 2] int64 (src, dst) meaning src -> dst


@dataclass
class Adjacency:
    """Edge list and receiver in-degree normalisation weights."""

    src: torch.Tensor   # [E] int64
    dst: torch.Tensor   # [E] int64
    wgt: torch.Tensor   # [E] float32 = 1 / indeg(dst)
    n: int

    @classmethod
    def build(cls, edges: Edges, n: int, transpose: bool = False, device=None) -> "Adjacency":
        e = np.asarray(edges, np.int64)
        src, dst = (e[:, 0], e[:, 1]) if not transpose else (e[:, 1], e[:, 0])
        indeg = np.bincount(dst, minlength=n).astype(np.float32)
        wgt = 1.0 / np.maximum(indeg[dst], 1.0)
        t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        return cls(src=t(src), dst=t(dst), wgt=t(wgt.astype(np.float32)), n=n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x: the mean over each receiver's predecessors."""
        msgs = x[self.src] * self.wgt[:, None].to(x.dtype)
        return torch.zeros((self.n, x.shape[1]), dtype=x.dtype, device=x.device).index_add_(
            0, self.dst, msgs)


def parse_hidden_layers(spec: str) -> Tuple[List[int], List[bool], bool]:
    """The reference's 'd2048,d' layer spec (``models/gcn.py:53-76``): a
    leading 'd' is dropout before that conv; a trailing lone 'd' is dropout
    before the output conv."""
    parts = spec.split(",")
    dropout_last = False
    if parts and parts[-1] == "d":
        dropout_last = True
        parts = parts[:-1]
    dims: List[int] = []
    drops: List[bool] = []
    for c in parts:
        d = c.startswith("d")
        drops.append(d)
        dims.append(int(c[1:] if d else c))
    return dims, drops, dropout_last


@dataclass
class GCNConfig:
    n: int
    in_channels: int
    out_channels: int
    hidden_layers: str = "d2048,d"
    mode: str = "basic"        # basic | dense | dense_att
    n_hops: int = 1            # adjacency sets for dense_att
    dropout_rate: float = 0.5


def _channels(cfg: GCNConfig) -> List[int]:
    dims, _, _ = parse_hidden_layers(cfg.hidden_layers)
    return [cfg.in_channels] + dims + [cfg.out_channels]


def gcn_init(generator: torch.Generator, cfg: GCNConfig, device=None) -> Dict:
    """Xavier-uniform weights and zero biases per graph conv; attention
    logits of ones for ``dense_att`` (``gcn.py:71-77,109-122``)."""
    chans = _channels(cfg)
    convs = []
    for a, b in zip(chans[:-1], chans[1:]):
        bound = float(np.sqrt(6.0 / (a + b)))
        convs.append({"w": (torch.rand((a, b), generator=generator) * 2 - 1) * bound,
                      "b": torch.zeros(b)})
    params: Dict = {"convs": convs}
    if cfg.mode == "dense_att":
        params["a_att"] = torch.ones(cfg.n_hops)
        params["r_att"] = torch.ones(cfg.n_hops)
    return from_numpy(params, device)


def from_jax(params, device=None) -> Dict:
    """A JAX ``gcn_init`` tree (as numpy) -> the port's (same structure)."""
    return from_numpy(params, device)


def draw_dropout_masks(generator: torch.Generator, cfg: GCNConfig,
                       device=None) -> List[Optional[torch.Tensor]]:
    """One keep mask per conv input that the spec drops out, else None: the
    draws that ``gcn_apply`` takes (``gcn.py:138-144`` draws them with
    ``jax.random.bernoulli``)."""
    _, drops, last = parse_hidden_layers(cfg.hidden_layers)
    keep = 1.0 - cfg.dropout_rate
    return [torch.rand((cfg.n, c), generator=generator).lt(keep).to(device) if d else None
            for c, d in zip(_channels(cfg)[:-1], drops + [last])]


def gcn_apply(
    params: Dict,
    cfg: GCNConfig,
    x: torch.Tensor,                       # [N, in_channels]
    adj: Sequence[Adjacency],              # forward side (per hop for dense_att)
    r_adj: Optional[Sequence[Adjacency]] = None,
    dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,  # None = eval
) -> torch.Tensor:
    """Full-graph forward -> L2-normalised predicted classifiers [N, out]."""
    keep = 1.0 - cfg.dropout_rate
    n_layers = len(params["convs"])
    h = x
    for i, conv in enumerate(params["convs"]):
        if dropout_masks is not None and dropout_masks[i] is not None:
            h = torch.where(dropout_masks[i], h / keep, 0.0)
        support = h @ conv["w"] + conv["b"]
        use_reverse = cfg.mode in ("dense", "dense_att") and i % 2 == 1
        side = r_adj if use_reverse else adj
        if cfg.mode == "dense_att":
            att = torch.softmax(params["r_att"] if use_reverse else params["a_att"], dim=0)
            out = sum(a.matvec(support) * att[j] for j, a in enumerate(side))
        else:
            out = side[0].matvec(support)
        h = torch.relu(out) if i < n_layers - 1 else out
    return h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True), 1e-12)


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference ``l2_loss`` (``baseline/DGP/utils.py:52-53``)."""
    return torch.sum((a - b) ** 2) / (a.shape[0] * 2)


def masked_l2_loss(pred: torch.Tensor, target: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """L2 over the seen rows (``train_gcn_dense_att.py:18-19``); the runner
    passes integer seen ids, so this is a gather and the divisor is their
    count times 2."""
    return l2_loss(pred[idx], target[idx])


def make_gcn_train_step(cfg: GCNConfig, tx: Adam, adj, r_adj=None) -> Callable:
    """-> ``step(params, opt, x, fc_vectors, seen_idx, dropout_masks) ->
    (params, opt, loss)``: one full-graph Adam step in place."""

    def step(params, opt, x, fc_vectors, seen_idx, dropout_masks=None):
        pred = gcn_apply(params, cfg, x, adj, r_adj, dropout_masks)
        loss = masked_l2_loss(pred, fc_vectors, seen_idx)
        tx.apply(params, opt, grads(loss, tree_leaves(params)))
        return params, opt, loss.detach()

    return step


def dense_edges(hier, max_hops: Optional[int] = None) -> List[Edges]:
    """Transitive-closure ancestor -> descendant edges grouped by hop
    distance, with self-loops in group 0; hops from ``max_hops`` on merge
    into the last group (``materials/make_dense_grouped_graph.py``,
    ``train_gcn_dense_att.py:49-53``)."""
    n = hier.num_nodes
    groups: Dict[int, List[Tuple[int, int]]] = {0: [(i, i) for i in range(n)]}
    for node in range(n):
        chain = hier.chain(node)
        for d, anc in enumerate(chain):
            groups.setdefault(len(chain) - d, []).append((anc, node))
    hops = sorted(groups)
    if max_hops is not None and len(hops) > max_hops:
        head, tail = hops[:max_hops - 1], hops[max_hops - 1:]
        merged = [e for h in tail for e in groups[h]]
        return [np.asarray(groups[h], np.int64) for h in head] + [np.asarray(merged, np.int64)]
    return [np.asarray(groups[h], np.int64) for h in hops]


def basic_edges(hier, self_loops: bool = True) -> Edges:
    """Parent -> child edges (and self loops): the SGCN adjacency."""
    out = [(p, c) for p in range(hier.num_nodes) for c in hier.children(p)]
    if self_loops:
        out.extend((i, i) for i in range(hier.num_nodes))
    return np.asarray(out, np.int64)
