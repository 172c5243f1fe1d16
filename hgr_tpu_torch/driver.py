"""Top-level driver: OM fine-tuning and zero-shot evaluation (port of
``hgr_tpu/driver.py:36-254``, ``:337-629``).

Equivalents of the reference's ``train()`` (``main.py:72-101``), ``test()``
(``main.py:104-222``) and ``main()`` (``main.py:225-267``) on one CUDA
device, with synthetic hierarchies and images:

- ``run_test`` builds the class bank with the text tower (through the fused
  attention kernel), sorts it by depth, then runs every single-class image
  batch through the image tower and the depth-sorted metrics;
- ``run_train`` runs the OM (or hierarchical) train step over grouped
  single-class batches, checkpoints every epoch, and resumes, mid-epoch
  too, with ``--resume``.

Paths the port does not run yet raise instead of being ignored: flat
training, CoOp, checkpoint loading (``--load``, ``--fetch``), multi-device
meshes, profiler traces, real image files, decode processes and caches,
and k-shot subsampling (``require_ported``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .config import Config
from .data import GroupedTestLoader, GroupedTrainLoader, Prefetcher, SyntheticImageSource
from .eval.metrics import accumulate, summarize, zeros_metrics
from .hierarchy import Hierarchy, synthetic_hierarchy
from .tree_model import TreeModel
from .utils.logging import RunLogger


class NotYetPorted(NotImplementedError):
    pass


def require_ported(config: Config) -> None:
    """Raise for every option that selects a path the port does not run."""
    refused = {
        "--training_method flat": config.train and config.training_method == "flat",
        "--coop": config.coop,
        "--load": config.load,
        "--fetch": config.fetch,
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


def run_train(config: Config, tm: TreeModel, splits, logger: RunLogger) -> Any:
    """OM fine-tuning (reference ``train()`` + driver, ``main.py:72-101,
    225-258``); returns the final TrainState."""
    from .train import (
        NegativeSampler,
        ScheduleBuilder,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    require_ported(config)
    grouped = grouped_split(config, splits[config.data_train])
    loader = GroupedTrainLoader(
        grouped,
        {c: tm.hier.name_to_id[c] for c in grouped},
        SyntheticImageSource(tm.clip_cfg.image_resolution),
        config.batch_size,
        n_episodes=config.n_episodes,
        seed=config.seed,
        num_threads=config.num_workers,
        serial_batches=config.serial_batches,
    )
    steps_per_epoch = loader.n_episodes
    tx = make_optimizer(config, config.epochs * steps_per_epoch)
    state = init_train_state(tm.model, tm.layer_weight, tx)
    resume_meta = None
    if config.resume:
        from .utils.checkpoint import latest_epoch, read_ckpt_meta, restore_checkpoint

        # --resume without --from_epoch takes the newest clip_{N}, so a
        # preempted worker re-runs its original command as it was
        epoch = config.from_epoch if config.from_epoch >= 0 else latest_epoch(config.save_path)
        if epoch is None:
            logger.log_text("resume: no checkpoint found; starting fresh")
        else:
            ckpt = os.path.join(config.save_path, f"clip_{epoch}")
            state = restore_checkpoint(ckpt, state)
            config.from_epoch = epoch
            resume_meta = read_ckpt_meta(config.save_path, epoch)
            logger.log_text(f"resumed full state from {ckpt} (step {state.step})")
    step_fn = make_train_step(config, tx, dtype=tm.dtype)

    sampler = NegativeSampler(tm.hier, tm.train_index, config.num_compare, k=config.k,
                              seed=config.seed, exclu_bro=config.exclu_bro)
    builder = ScheduleBuilder(tm.hier, sampler, config.out_ratio, config.in_ratio,
                              config.num_compare, method=config.training_method,
                              strategy=config.sample_strategy)
    node_tokens = torch.as_tensor(tm.node_tokens, device=tm.device).long()

    # mid-epoch resume: when the sidecar says the saved epoch stopped part
    # way (steps_done < steps_per_epoch) and the geometry matches, re-enter
    # that epoch at the saved step instead of skipping its remaining data
    resume_skip = 0
    if (resume_meta is not None
            and resume_meta.get("steps_per_epoch") == steps_per_epoch
            and 0 < resume_meta.get("steps_done", steps_per_epoch) < steps_per_epoch):
        resume_skip = int(resume_meta["steps_done"])
        config.from_epoch -= 1
        logger.log_text(
            f"resume: re-entering epoch {config.from_epoch + 1} at step "
            f"{resume_skip}/{steps_per_epoch} (mid-epoch preemption)"
        )
    pending_skip = {"steps": resume_skip}

    def prefetch_steps():
        """Batches and their pair schedules, made in a background thread so
        that schedule building overlaps the device step."""
        skip = pending_skip.pop("steps", 0)  # the first epoch only
        if skip:
            loader.skip_next(skip)
        for batch in loader:
            yield batch.images, builder.build(batch.target)

    logger.log_config(config)
    try:
        return _epoch_loop(config, tm, splits, logger, state, step_fn, sampler,
                           loader, node_tokens, prefetch_steps, steps_per_epoch, resume_skip)
    finally:
        loader.close()


def _epoch_loop(config, tm, splits, logger, state, step_fn, sampler, loader, node_tokens,
                prefetch_steps, steps_per_epoch, resume_skip=0):
    from .train import sched_to_device
    from .utils.checkpoint import AsyncCheckpointSaver
    from .utils.preempt import GracefulShutdown

    dev = tm.device
    with AsyncCheckpointSaver(keep=config.keep_checkpoints) as saver, \
            GracefulShutdown() as shutdown:
        for epoch in range(config.from_epoch + 1, config.epochs):
            epoch_t0 = time.time()
            # the loader's streams follow the absolute epoch, so a restarted
            # process re-enters a preempted epoch on the same batches
            loader.set_epoch(epoch)
            if config.sample_strategy in ("simi", "near_simi"):
                # refresh the similarity-ranking bank once per epoch (the
                # reference re-encodes per step inside no_grad)
                bank = tm.update_classifier()
                sampler.set_class_feats(bank[: tm.hier.num_nodes].float().cpu().numpy())
            skip_base = resume_skip if epoch == config.from_epoch + 1 else 0
            steps_done = skip_base
            steps = Prefetcher(prefetch_steps, depth=2)
            try:
                for i, (images, sched_host) in enumerate(steps):
                    state, loss = step_fn(state, torch.from_numpy(images).to(dev), node_tokens,
                                          sched_to_device(sched_host, dev))
                    if i % config.print_freq == 0:
                        logger.log_train(epoch, skip_base + i, steps_per_epoch, float(loss))
                    steps_done = skip_base + i + 1
                    if shutdown.requested:
                        # SIGTERM: stop at this step boundary; the checkpoint
                        # below still runs, then the run exits for --resume
                        break
            finally:
                steps.stop()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            epoch_dt = time.time() - epoch_t0
            steps_run = steps_done - skip_base
            logger.log_jsonl({
                "event": "epoch_perf",
                "epoch": epoch,
                "steps": steps_run,
                "step_ms": round(epoch_dt / max(steps_run, 1) * 1e3, 1),
                "imgs_per_sec": round(steps_run * config.batch_size / max(epoch_dt, 1e-9), 1),
            })
            saver.save(config.save_path, epoch, state,
                       meta={"steps_done": steps_done, "steps_per_epoch": steps_per_epoch})
            logger.log_text(f"Model saved. epoch={epoch}")
            if shutdown.requested:
                logger.log_text(
                    f"preempted (SIGTERM): saved epoch={epoch} after {steps_done}/"
                    f"{steps_per_epoch} steps; --resume True re-enters this epoch at "
                    "the saved step"
                )
                break
            if config.test_after_train:
                run_test(config, tm, splits, logger)
    return state


def main(argv=None) -> Any:
    config = Config.from_args(argv)
    hier, splits = build_hierarchy(config)
    print("Creating models", flush=True)
    tm = build_model(config, hier, splits)
    logger = RunLogger(config.save_path)
    if config.train:
        print("Training.", flush=True)
        return run_train(config, tm, splits, logger)
    print("Direct testing.", flush=True)
    return run_test(config, tm, splits, logger)
