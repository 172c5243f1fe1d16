"""CNZSL baseline: class embedding -> visual prototype MLP with class
standardization (port of ``hgr_tpu/baselines/cnzsl.py``).

The reference's ``baseline/CNZSL/cnzsl.py:139-377``:

- a 3-layer MLP from class embeddings to 2048-d prototypes with two
  ClassStandardization layers (running-stat normalisation without affine
  over the CLASS axis) and the paper's "proper init" of the last linear;
- logits = (5 l2norm(feats)) @ (5 l2norm(protos)).T;
- cross-entropy over the seen classes; evaluation uses the running
  statistics (``cnzsl.py:225``), which move only in training.

As in the JAX package the running statistics are a ``state`` tree that
the train step returns anew. Two quirks are kept: the variance is the
population variance, and the divisor is ``var + 1e-5``, not its square
root (``cnzsl.py:77,83``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .optim import Adam, from_numpy, grads, tree_leaves


@dataclass
class CNZSLConfig:
    attr_dim: int
    proto_dim: int = 2048
    hid_dim: int = 1024
    use_class_standardization: bool = True
    use_proper_init: bool = True
    scale: float = 5.0
    momentum: float = 0.1


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2 - 1) * bound


def cnzsl_init(generator: torch.Generator, cfg: CNZSLConfig, device=None) -> Tuple[Dict, Dict]:
    """torch ``nn.Linear``'s U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every
    layer, then the proper init U(-b, b), b = sqrt(3 / (hid * proto)), of
    the last weight (``cnzsl.py:40-68``), drawn from ``generator``."""
    def linear(a, b):
        bound = float(np.sqrt(1.0 / a))
        return {"w": _uniform(generator, (a, b), bound), "b": _uniform(generator, (b,), bound)}

    params = {"fc1": linear(cfg.attr_dim, cfg.hid_dim),
              "fc2": linear(cfg.hid_dim, cfg.hid_dim),
              "fc3": linear(cfg.hid_dim, cfg.proto_dim)}
    if cfg.use_proper_init:
        b = float(np.sqrt(3.0 / (cfg.hid_dim * cfg.proto_dim)))
        params["fc3"]["w"] = _uniform(generator, (cfg.hid_dim, cfg.proto_dim), b)
    state = {k: {"mean": np.zeros(cfg.hid_dim), "var": np.ones(cfg.hid_dim)}
             for k in ("cs1", "cs2")}
    return from_numpy(params, device), from_numpy(state, device, requires_grad=False)


def from_jax(params, state, device=None) -> Tuple[Dict, Dict]:
    """JAX ``cnzsl_init`` trees (as numpy) -> the port's (same structure)."""
    return from_numpy(params, device), from_numpy(state, device, requires_grad=False)


def _standardize(x: torch.Tensor, st: Dict, training: bool, momentum: float):
    """ClassStandardization (``cnzsl.py:71-83``): over the class axis;
    running statistics updated in training, used as they are in eval."""
    if training:
        mean = x.mean(dim=0)
        var = x.var(dim=0, correction=0)
        out = (x - mean[None]) / (var[None] + 1e-5)
        new = {"mean": (1 - momentum) * st["mean"] + momentum * mean.detach(),
               "var": (1 - momentum) * st["var"] + momentum * var.detach()}
        return out, new
    return (x - st["mean"][None]) / (st["var"][None] + 1e-5), st


def cnzsl_protos(params: Dict, state: Dict, attrs: torch.Tensor, cfg: CNZSLConfig,
                 training: bool) -> Tuple[torch.Tensor, Dict]:
    relu = torch.relu
    h = relu(attrs @ params["fc1"]["w"] + params["fc1"]["b"])
    h = h @ params["fc2"]["w"] + params["fc2"]["b"]
    cs1, cs2 = state["cs1"], state["cs2"]
    if cfg.use_class_standardization:
        h, cs1 = _standardize(h, cs1, training, cfg.momentum)
    h = relu(h)
    if cfg.use_class_standardization:
        h, cs2 = _standardize(h, cs2, training, cfg.momentum)
    protos = relu(h @ params["fc3"]["w"] + params["fc3"]["b"])
    return protos, {"cs1": cs1, "cs2": cs2}


def _scaled_unit(x: torch.Tensor, scale: float) -> torch.Tensor:
    return scale * x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True), 1e-12)


def cnzsl_scores(feats: torch.Tensor, protos: torch.Tensor, cfg: CNZSLConfig) -> torch.Tensor:
    """(5 l2norm(feats)) @ (5 l2norm(protos)).T"""
    return _scaled_unit(feats, cfg.scale) @ _scaled_unit(protos, cfg.scale).T


def cnzsl_logits(params: Dict, state: Dict, feats: torch.Tensor, attrs: torch.Tensor,
                 cfg: CNZSLConfig, training: bool = False) -> Tuple[torch.Tensor, Dict]:
    """[B, proto_dim] features x [C, attr_dim] class embeddings -> [B, C]
    logits and the (possibly updated) running statistics."""
    protos, new_state = cnzsl_protos(params, state, attrs, cfg, training)
    return cnzsl_scores(feats, protos, cfg), new_state


def make_cnzsl_train_step(cfg: CNZSLConfig, tx: Adam) -> Callable:
    """-> ``step(params, state, opt, feats, attrs, labels) -> (params,
    new_state, opt, loss)``: mean cross-entropy, one Adam update in place."""

    def step(params, state, opt, feats, attrs, labels):
        logits, new_state = cnzsl_logits(params, state, feats, attrs, cfg, training=True)
        loss = torch.nn.functional.cross_entropy(logits, labels.long())
        tx.apply(params, opt, grads(loss, tree_leaves(params)))
        return params, new_state, opt, loss.detach()

    return step
