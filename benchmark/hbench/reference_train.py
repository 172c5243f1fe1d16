"""Plain OM fine-tuning: the reference of the training cell.

The OM step of the HGR-Net paper as the program's configuration states it
(``out_ratio``, ``in_ratio``, ``num_compare``, the ``topk`` sampling rule
with ``k = 1``, ``adaptive`` pair weights over a trainable per-depth
weight, a global-norm clip, AdamW on CLIP and SGD on the per-depth weight),
written from that description over the float32 encoders of the
configuration's family (``hbench/family.py``). It imports nothing of the
program.

For a target class t with root path P (root child .. t), the outer loop
takes the last ``ceil(out_ratio |P|)`` nodes of P, deepest first; for each
such node o with root path Q the inner loop takes the last
``ceil(in_ratio |Q|)`` nodes of Q, deepest first; for each inner node at
depth d the compare set is up to ``num_compare`` classes drawn from the
level above d (the root's children at d = 0) less Q, and then o, the
positive. Each pair's cross-entropy over the batch's images is weighted by
``softmax(100 ** w[:n])[i]`` of its inner and its outer position.

The negatives are a random draw. The reference checks the program's draw
against the rule (:func:`check_schedule`) and takes it; the control draws
its own (:func:`draw_compare_sets`).
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import reference
from .inputs import Tree

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def ceil_ratio(ratio: float, n: int) -> int:
    return max(math.ceil(ratio * n), 1)


def pairs(tree: Tree, target: int, out_ratio: float, in_ratio: float
          ) -> List[Tuple[int, List[int], int, int, int, int]]:
    """(positive, inner path, depth, inner pos, inner len, outer pos, outer
    len) of each pair of ``target``, in loop order."""
    path = tree.path(target)
    kk = ceil_ratio(out_ratio, len(path))
    out = []
    for k_loop, o in enumerate(path[::-1][:kk]):
        q = tree.path(o)
        mm = ceil_ratio(in_ratio, len(q))
        for m_loop, p_in in enumerate(q[::-1][:mm]):
            out.append((o, q, q.index(p_in), m_loop, mm, k_loop, kk))
    return out


def pool_of(tree: Tree, levels: Dict[int, np.ndarray], q: Sequence[int], depth: int) -> set:
    """Candidate negatives at ``depth``: the level above (the root's
    children at depth 0), less the inner path ``q``."""
    lev = levels[max(depth - 1, 0)]
    return set(int(x) for x in lev) - set(int(x) for x in q)


def levels_of(tree: Tree) -> Dict[int, np.ndarray]:
    return {int(d): np.flatnonzero(tree.depth == d) for d in np.unique(tree.depth)}


def check_schedule(tree: Tree, levels, target: int, compare: np.ndarray,
                   valid: np.ndarray, label: np.ndarray, pair_valid: np.ndarray,
                   ratios: Tuple[float, float], num_compare: int) -> List[List[int]]:
    """The program's compare sets of ``target``'s pairs, each checked against
    the rule: the pair count, distinct classes, the negatives drawn from the
    pool in the rule's number, the positive last. Raises ``ValueError``
    where the draw breaks the rule; returns the sets."""
    ps = pairs(tree, target, *ratios)
    if int(pair_valid.sum()) != len(ps) or not pair_valid[: len(ps)].all():
        raise ValueError(f"target {target}: {int(pair_valid.sum())} pairs, the rule has {len(ps)}")
    sets = []
    for i, (o, q, depth, *_rest) in enumerate(ps):
        ids = [int(x) for x in compare[i][valid[i]]]
        pool = pool_of(tree, levels, q, depth)
        neg = ids[:-1]
        if (ids[-1] != o or int(label[i]) != len(ids) - 1 or len(set(ids)) != len(ids)
                or not set(neg) <= pool or len(neg) != min(num_compare, len(pool))):
            raise ValueError(f"target {target}, pair {i}: the compare set breaks the rule")
        sets.append(ids)
    return sets


def draw_compare_sets(tree: Tree, levels, target: int, ratios, num_compare: int,
                      rng: np.random.Generator) -> List[List[int]]:
    """A draw of the rule: the control's own negatives."""
    sets = []
    for o, q, depth, *_rest in pairs(tree, target, *ratios):
        pool = sorted(pool_of(tree, levels, q, depth))
        neg = list(rng.choice(pool, size=min(num_compare, len(pool)), replace=False))
        sets.append([int(x) for x in neg] + [o])
    return sets


def adaptive(w: torch.Tensor, pos: int, n: int) -> torch.Tensor:
    return torch.softmax(torch.pow(100.0, w[:n]), dim=0)[pos]


def om_loss(fam: ModuleType, sd: Dict[str, torch.Tensor], lw: torch.Tensor, cfg: Dict,
            images: torch.Tensor, tokens: torch.Tensor, tree: Tree, target: int,
            sets: List[List[int]], ratios, quant=None, chunk: int = 64) -> torch.Tensor:
    """The OM loss of one batch of one target through the encoders of the
    configuration's family ``fam`` (``hbench/family.py``), with its
    gradient taken by autograd; the image tower runs in chunks of ``chunk``
    rows, each backpropagated at once, so the returned value is detached."""
    ps = pairs(tree, target, *ratios)
    uniq = sorted({c for s in sets for c in s})
    pos = {c: i for i, c in enumerate(uniq)}
    toks = tokens[torch.as_tensor(uniq, device=tokens.device)]
    toks = toks[:, : int(toks.argmax(dim=1).max()) + 1]
    text = reference.normalize(fam.encode_text(sd, cfg, toks, quant))            # [U, D]
    idx = [torch.as_tensor([pos[c] for c in s], device=text.device) for s in sets]
    w = torch.stack([adaptive(lw, p[3], p[4]) * adaptive(lw, p[5], p[6]) for p in ps])
    scale = sd["logit_scale"].exp()
    B = images.shape[0]
    total = 0.0
    text_d = text.detach().requires_grad_(True)
    w_d = w.detach().requires_grad_(True)
    scale_d = scale.detach().requires_grad_(True)
    for i in range(0, B, chunk):
        img = reference.normalize(fam.encode_image(sd, cfg, images[i: i + chunk], quant))
        part = 0.0
        for p, ix in enumerate(idx):
            logits = scale_d * img @ text_d[ix].T                                  # [b, C]
            ce = torch.logsumexp(logits, dim=1) - logits[:, -1]
            part = part + w_d[p] * ce.sum() / B
        part.backward()
        total += float(part.detach())
    # the text tower, the weights and the scale take their summed gradients
    torch.autograd.backward([text, w, scale], [text_d.grad, w_d.grad, scale_d.grad])
    return torch.tensor(total)


def cosine_lr(base: float, warmup: int, total: int, step: int) -> float:
    """Linear warm-up, then cosine decay to 0 over ``total`` steps."""
    if warmup > 0 and step < warmup:
        return base * (step + 1.0) / warmup
    return 0.5 * (1.0 + math.cos(math.pi * (step - warmup) / max(total - warmup, 1))) * base


class Trainer:
    """AdamW over the CLIP tensors after a global-norm clip, SGD over the
    per-depth weight, in float32 from the drawn weights."""

    def __init__(self, sd: Dict[str, torch.Tensor], lw: torch.Tensor, hp: Dict):
        self.params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        self.lw = lw.clone().requires_grad_(True)
        self.hp = hp
        self.m = {k: torch.zeros_like(v) for k, v in sd.items()}
        self.v = {k: torch.zeros_like(v) for k, v in sd.items()}
        self.t = 0

    @torch.no_grad()
    def update(self) -> Dict[str, torch.Tensor]:
        """One update from the gradients in ``.grad``; returns the clipped
        gradients the optimizer took."""
        hp = self.hp
        g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in self.params.items()}
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
        if norm >= hp["grad_clip"]:
            g = {k: x * (hp["grad_clip"] / norm).float() for k, x in g.items()}
        lr = cosine_lr(hp["lr"], hp["warmup_length"], hp["schedule_steps"], self.t)
        self.t += 1
        bc1, bc2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        for k, p in self.params.items():
            self.m[k].mul_(BETA1).add_(g[k], alpha=1 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g[k], g[k], value=1 - BETA2)
            p.mul_(1 - lr * hp["wd"])
            denom = self.v[k].sqrt() / math.sqrt(bc2) + ADAM_EPS
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
            p.grad = None
        if self.lw.grad is not None:
            self.lw -= hp["w_lr"] * self.lw.grad
            self.lw.grad = None
        return g
