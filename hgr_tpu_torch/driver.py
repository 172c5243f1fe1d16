"""Top-level driver for zero-shot evaluation (port of
``hgr_tpu/driver.py:36-254``).

Equivalent of the reference's ``test()`` (``main.py:104-222``) on one CUDA
device: build the class bank with the text tower (through the fused
attention kernel), sort it by depth, then run every single-class image batch
through the RN50 tower and the depth-sorted metrics. Paths the port does not
run yet (training, CoOp, checkpoint loading, multi-device meshes, real
image files) raise instead of being ignored.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from .config import Config
from .data import GroupedTestLoader, SyntheticImageSource
from .eval.metrics import accumulate, summarize, zeros_metrics
from .hierarchy import Hierarchy, synthetic_hierarchy
from .tree_model import TreeModel
from .utils.logging import RunLogger


class NotYetPorted(NotImplementedError):
    pass


def require_ported(config: Config) -> None:
    """Raise for every option that selects a path the port does not run."""
    refused = {
        "--train True": config.train,
        "--coop": config.coop,
        "--load": config.load,
        "--fetch": config.fetch,
        "--resume": config.resume,
        "--mesh_data/--mesh_model": config.mesh_data not in (-1, 1) or config.mesh_model != 1,
        "a non-synthetic image source (--synthetic False)": not config.synthetic,
        "--num_proc_workers": config.num_proc_workers > 0,
        "--decode_cache": bool(config.decode_cache),
        "--k_shots": config.k_shots > 0,
        "--trace_dir": bool(config.trace_dir),
    }
    on = [name for name, set_ in refused.items() if set_]
    if on:
        raise NotYetPorted(f"not yet ported to hgr_tpu_torch: {', '.join(on)}")


def synthetic_splits(hier: Hierarchy, seed: int) -> Dict[str, list]:
    """Two thirds of the nodes as seen ("train"), the rest unseen."""
    rng = np.random.default_rng(seed)
    names = list(hier.names)
    n_train = max(1, len(names) * 2 // 3)
    perm = rng.permutation(len(names))
    train = [names[i] for i in sorted(perm[:n_train])]
    rest = [names[i] for i in sorted(perm[n_train:])]
    return {"train": train, "rest": rest, "all": train + rest}


def build_hierarchy(config: Config) -> Tuple[Hierarchy, Dict[str, list]]:
    """Synthetic hierarchy + splits from config (the JSON artifacts of a
    real run need the not yet ported tokenizer and image files)."""
    require_ported(config)
    hier = synthetic_hierarchy(
        branching=config.synthetic_branching,
        levels=config.synthetic_levels,
        extra_edges=config.synthetic_extra_edges,
        seed=config.seed,
    )
    return hier, synthetic_splits(hier, config.seed)


def build_model(
    config: Config, hier: Hierarchy, splits: Dict[str, list], device=None
) -> TreeModel:
    """TreeModel with random weights from ``config.seed`` on ``device``
    (default ``cuda:{config.device}``)."""
    require_ported(config)
    tm = TreeModel.build(
        config,
        hier,
        candidates_train=splits[config.model_train],
        candidates_test=splits[config.model_test],
        pad_multiple=1024 if hier.num_nodes > 1024 else 128,
        seed=config.seed,
        device=device,
    )
    tm.init_params(config.seed)
    return tm


def grouped_split(config: Config, candidates) -> Dict[str, list]:
    """Synthetic per-class image lists (``driver.py:125-134``)."""
    per = config.synthetic_images_per_class
    return {c: [f"{c}/{j}.jpg" for j in range(per)] for c in candidates}


def run_test(config: Config, tm: TreeModel, splits, logger: RunLogger) -> Dict[str, float]:
    """Zero-shot evaluation (reference ``test()``, ``main.py:104-222``)."""
    require_ported(config)
    dev = tm.device
    bank_s = tm.sort_bank(tm.update_classifier())

    grouped = grouped_split(config, splits[config.data_test])
    loader = GroupedTestLoader(
        grouped,
        {c: tm.hier.name_to_id[c] for c in grouped},
        SyntheticImageSource(tm.clip_cfg.image_resolution),
        config.test_batch_size,
        num_threads=config.num_workers,
    )
    logger.log_text(f"number of batches:{loader.num_batches}")

    total = zeros_metrics(device=dev)
    t0 = time.time()
    n_img = 0
    try:
        for i, batch in enumerate(loader):
            images = torch.from_numpy(batch.images).to(dev)
            valid = torch.from_numpy(batch.valid).to(dev)
            total = accumulate(
                total, tm.eval_step_sorted(bank_s, images, batch.target, valid=valid)
            )
            n_img += int(batch.valid.sum())
            if i % config.print_freq == 0:
                logger.log_eval(summarize(total), tag=f"batch {i}/{loader.num_batches}")
            if 0 < config.max_test_batches <= i + 1:
                logger.log_text(f"stopping early at {i + 1} batches (max_test_batches)")
                break
    finally:
        loader.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    summary = summarize(total)
    summary["imgs_per_sec"] = n_img / max(dt, 1e-9)
    logger.log_text("End of testing.")
    logger.log_eval(summary, tag="final")
    logger.log_global_summary(config.weights, config.out_ratio, config.in_ratio, summary)
    return summary


def main(argv=None) -> Dict[str, float]:
    config = Config.from_args(argv)
    hier, splits = build_hierarchy(config)
    print("Creating models", flush=True)
    tm = build_model(config, hier, splits)
    logger = RunLogger(config.save_path)
    print("Direct testing.", flush=True)
    return run_test(config, tm, splits, logger)
