"""The program under test, built from the benchmark's inputs, and the
set-up clock.

The program is ``hgr_tpu_torch``, driven through its public entry points:
``Hierarchy.from_edges`` takes the benchmark's edge list, ``TreeModel.build``
its unseen classes and the run's seed (the program draws its synthetic
prompts from it, which the reference draws again from its own copy of the
convention), and ``TreeModel.load_state_dict`` the weights the benchmark
drew on the card by the configuration's family (``hbench/family.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Tuple

import numpy as np

from . import inputs


class SetupClock:
    """Seconds of set-up by part, from the process's start."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.parts: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t

    def line(self, t_window: float) -> str:
        total = t_window - self.t_start
        rest = total - sum(self.parts.values())
        parts = " ".join(f"{k}={v:.3f}" for k, v in self.parts.items())
        return f"# setup_s {total:.3f}: {parts} other={rest:.3f}"


@dataclass
class Classes:
    """The class set every configuration shares, as the benchmark made it."""

    edges: List[Tuple[str, str]]
    tree: inputs.Tree
    unseen: np.ndarray            # sorted ids of the unseen classes
    seed: int                     # the run's seed: prompts, split, targets

    @property
    def num_nodes(self) -> int:
        return self.tree.num_nodes

    def tokens(self, cfg: Dict) -> np.ndarray:
        t = cfg["text"]
        return inputs.synthetic_tokens(self.num_nodes, t["context_length"], t["vocab_size"],
                                       self.seed)


def make_classes(cfg: Dict, seed: int) -> Classes:
    c = cfg["classes"]
    edges = inputs.profiled_edges(c["level_sizes"], c["hierarchy_seed"], c["cross_edges"])
    tree = inputs.Tree(edges)
    return Classes(edges, tree, inputs.split_unseen(tree.num_nodes, seed, c["n_seen"]), seed)


def weight_seed(seed: int) -> int:
    return inputs.torch_seed(seed, 41)


@dataclass
class Program:
    tm: object                    # hgr_tpu_torch.tree_model.TreeModel
    classes: Classes
    weights: Dict = field(default_factory=dict)  # the drawn state dict, where a cell keeps it


def build_program(family: ModuleType, cfg: Dict, seed: int, device, clock: SetupClock,
                  keep_weights: bool = False) -> Program:
    """The TreeModel of ``cfg`` over the benchmark's classes and the weights
    ``family`` draws."""
    with clock.part("imports"):
        from hgr_tpu_torch.config import Config
        from hgr_tpu_torch.hierarchy import Hierarchy
        from hgr_tpu_torch.tree_model import TreeModel
    with clock.part("hierarchy"):
        classes = make_classes(cfg, seed)
        hier = Hierarchy.from_edges(classes.edges)
    with clock.part("model"):
        config = Config(arch=cfg["arch"], dtype=cfg["dtype"])
        tm = TreeModel.build(config, hier,
                             candidates_test=[hier.names[i] for i in classes.unseen],
                             pad_multiple=cfg["classes"]["pad_multiple"], seed=seed,
                             device=device)
    with clock.part("weights"):
        sd = family.draw_weights(cfg, weight_seed(seed), device)
        tm.load_state_dict(sd)
    return Program(tm, classes, sd if keep_weights else {})
