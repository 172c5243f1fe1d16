"""Single dataclass config with CLI overrides.

The port's own copy of ``hgr_tpu/config.py``: the same ``Config`` fields,
flag names and defaults (themselves the reference's, ``main.py:14-70``), so
``python -m hgr_tpu_torch`` takes the reference's command lines. Fields that
select a path the port does not run yet are refused by the driver
(``driver.require_ported``), never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields
from typing import List, Optional


class NotYetPorted(NotImplementedError):
    """An option or path of the JAX package that the port does not run yet."""


def _parse_bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v!r}")


@dataclass
class Config:
    # experiment (reference main.py:16-21)
    exp_name: str = "HGR"
    folder: str = "adaptive"
    print_freq: int = 1000
    debug: bool = False
    test_after_train: bool = False
    # the reference selects `cuda:{device}` (main.py:18); so does the port
    device: int = 0

    # model (main.py:24)
    arch: str = "RN50"

    # imagenet split selection (main.py:27-31)
    template: str = "TEMPLATES_SIMPLE"
    model_train: str = "all"
    model_test: str = "rest"
    data_train: str = "train"
    data_test: str = "rest"

    # data (main.py:34-43)
    graph_path: str = "data/process_results/graph_edges_cls.json"
    split_path: str = "data/process_results/splits_for_tree.json"
    num_workers: int = 12
    num_proc_workers: int = 0   # decode processes (data/mp_decode.py); 0 = threads
    decode_cache: str = ""      # decode cache root (data/decode_cache.py)
    keep_checkpoints: int = 0
    batch_size: int = 256
    test_batch_size: int = 512
    k_shots: int = -1
    serial_batches: bool = True
    n_episodes: int = -1
    data_split_train: str = "train"
    data_split_test: str = "zsl_test"
    hops_path: str = ""  # optional splits_for_hops.json; merges hop2/hop3/... keys
    max_test_batches: int = -1  # cap eval batches (quick validation runs)
    image_root: str = ""
    trace_dir: str = ""

    # train (main.py:46-62)
    open_eval: bool = True  # BN is frozen-stats by construction
    train: bool = True
    lr: float = 3e-7
    w_lr: float = 1e-4
    epochs: int = 10
    wd: float = 0.0
    warmup_length: int = 0
    num_compare: int = 256
    weights: str = "adaptive"  # equal|increasing|decreasing|adaptive|nl_increasing|nl_decreasing
    training_method: str = "OM"  # flat|hierarchical|OM
    sample_strategy: str = "topk"  # random|simi|topk|near_simi|brothers
    k: int = 1
    out_ratio: float = 0.25
    in_ratio: float = 0.5
    weighting: str = "both"  # in|out|both
    scale: float = 1.0
    grad_clip: float = 1.0
    accum_steps: int = 1
    seed: int = 0

    # resume (main.py:65-69)
    fetch: bool = False
    fetch_path: str = ""
    load: bool = False
    load_path: str = "none"
    from_epoch: int = -1
    resume: bool = False

    # ---- CoOp learned-prompt variant -------------------------------------
    coop: bool = False
    n_ctx: int = 16
    class_token_position: str = "end"  # end|middle|front
    coop_train: str = "clip"  # ctx|clip|both
    exclu_bro: bool = False

    # ---- synthetic mode (no ImageNet tree needed) -----------------------
    synthetic: bool = False
    synthetic_branching: int = 3
    synthetic_levels: int = 4
    synthetic_extra_edges: int = 5
    synthetic_images_per_class: int = 8

    # ---- accelerator section (names kept from the JAX package) -----------
    mesh_data: int = -1   # multi-device layout: not yet ported (one card)
    mesh_model: int = 1
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # master params
    # kept for command-line compatibility: on the card every attention run
    # without gradients (the class bank, the ViT image tower) is the fused
    # kernel (ops/attention.py) and the train step's is the plain one,
    # whatever this says
    pallas_attention: bool = False
    remat: bool = True             # training only
    vocab_path: str = ""
    names_path: str = ""
    donate: bool = True

    def __post_init__(self):
        _check = {
            "weights": ("equal", "increasing", "decreasing", "adaptive",
                        "nl_increasing", "nl_decreasing"),
            "training_method": ("flat", "hierarchical", "OM"),
            "sample_strategy": ("random", "simi", "topk", "near_simi", "brothers"),
            "weighting": ("in", "out", "both"),
            "dtype": ("bfloat16", "float32"),
            "coop_train": ("ctx", "clip", "both"),
            "class_token_position": ("end", "middle", "front"),
        }
        for name, options in _check.items():
            v = getattr(self, name)
            if v not in options:
                raise ValueError(
                    f"--{name} {v!r} is not one of {options}"
                )

    @property
    def save_path(self) -> str:
        """Reference path convention ``{folder}/{exp_name}/{weights}_{out}_{in}/``
        (``model/clip_tree.py:24``)."""
        return f"{self.folder}/{self.exp_name}/{self.weights}_{self.out_ratio}_{self.in_ratio}"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "Config":
        parser = argparse.ArgumentParser(description="HGR (PyTorch)")
        for f in fields(cls):
            if f.type == "bool" or isinstance(f.default, bool):
                # both "--load True/False" and the reference's bare
                # store_true style "--load" (main.py:64-66)
                parser.add_argument(
                    f"--{f.name}", type=_parse_bool, default=f.default,
                    nargs="?", const=True,
                )
            else:
                parser.add_argument(
                    f"--{f.name}", type=type(f.default), default=f.default
                )
        ns = parser.parse_args(argv)
        return cls(**vars(ns))
