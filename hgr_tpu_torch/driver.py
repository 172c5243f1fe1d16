"""Top-level driver: OM fine-tuning and zero-shot evaluation (port of
``hgr_tpu/driver.py:36-254``, ``:337-629``).

Equivalents of the reference's ``train()`` (``main.py:72-101``), ``test()``
(``main.py:104-222``) and ``main()`` (``main.py:225-267``) on one CUDA
device, over the reference's JSON artifacts or a synthetic stand-in
(``--synthetic True``):

- ``build_hierarchy`` reads ``graph_edges_cls.json``, the splits and the
  optional hops splits; ``build_model`` tokenises the node prompts with the
  BPE merges of ``--vocab_path`` and the names of ``--names_path``, then
  loads weights with ``--fetch`` or ``--load`` (the port's own checkpoints);
- ``run_test`` builds the class bank with the text tower (through the fused
  attention kernel), sorts it by depth, then runs every single-class image
  batch (image files through the manifests, a decode cache, or synthetic
  images) through the image tower and the depth-sorted metrics;
- ``run_train`` runs the OM (or hierarchical) train step over grouped
  single-class batches, checkpoints every epoch, and resumes, mid-epoch
  too, with ``--resume``; ``run_train_flat`` (``--training_method flat``)
  fine-tunes on shuffled multi-class batches with the CLIP-flat loss.

``--coop`` replaces the node prompts by the CoOp prompt learner
(``models/coop.py``) in the bank and in the OM step; ``--coop_train``
chooses what trains (the context, CLIP, or both).

``--num_proc_workers N`` decodes image files in N processes
(``data/mp_decode.py``) in every loader and in the decode cache's build;
``--trace_dir`` writes a Chrome trace of train steps 1-3
(``utils/profiling.TraceWindow``). Multi-device meshes, the one path the
port does not run yet, raise instead of being ignored (``require_ported``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .config import Config, NotYetPorted
from .data import (
    FileImageSource,
    GroupedTestLoader,
    GroupedTrainLoader,
    Prefetcher,
    SyntheticImageSource,
    kshot_subsample,
    load_manifest,
)
from .eval.metrics import accumulate, summarize, zeros_metrics
from .hierarchy import Hierarchy, synthetic_hierarchy
from .tree_model import TreeModel
from .utils.checkpoint import restore_params
from .utils.logging import RunLogger


def require_ported(config: Config) -> None:
    """Raise for every option that selects a path the port does not run."""
    refused = {
        "--mesh_data/--mesh_model": config.mesh_data not in (-1, 1) or config.mesh_model != 1,
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
    """Hierarchy and splits: synthetic, or the JSON artifacts
    (``--graph_path``, ``--split_path``, and ``--hops_path``'s hop2/hop3/...
    class lists merged into the splits)."""
    require_ported(config)
    if config.synthetic:
        hier = synthetic_hierarchy(
            branching=config.synthetic_branching,
            levels=config.synthetic_levels,
            extra_edges=config.synthetic_extra_edges,
            seed=config.seed,
        )
        return hier, synthetic_splits(hier, config.seed)
    hier = Hierarchy.from_json(config.graph_path)
    with open(config.split_path) as f:
        splits = json.load(f)
    if config.hops_path:
        with open(config.hops_path) as f:
            splits.update(json.load(f))
    return hier, splits


def build_model(
    config: Config, hier: Hierarchy, splits: Dict[str, list], device=None
) -> TreeModel:
    """TreeModel on ``device`` (default ``cuda:{config.device}``) with random
    weights from ``config.seed``, then those of ``--fetch_path`` and of
    ``--load`` (``--load_path``, or ``clip_{--from_epoch}`` under the save
    path) where set. Without ``--synthetic`` the prompts are BPE-tokenised;
    a missing merges file gives synthetic tokens, as in JAX."""
    require_ported(config)
    tokenizer = names = None
    if not config.synthetic:
        from .text import Tokenizer

        try:
            tokenizer = Tokenizer(config.vocab_path or None)
        except FileNotFoundError:
            print(f"no BPE merges file at --vocab_path {config.vocab_path!r} or "
                  "$HGR_TPU_BPE_VOCAB: the prompts are synthetic tokens", flush=True)
        if config.names_path and os.path.exists(config.names_path):
            with open(config.names_path) as f:
                names = json.load(f)
    tm = TreeModel.build(
        config,
        hier,
        candidates_train=splits[config.model_train],
        candidates_test=splits[config.model_test],
        tokenizer=tokenizer,
        names=names,
        pad_multiple=1024 if hier.num_nodes > 1024 else 128,
        seed=config.seed,
        device=device,
    )
    tm.init_params(config.seed)

    def apply(restored):
        tm.model.load_state_dict(restored["clip"])
        with torch.no_grad():
            tm.layer_weight.copy_(restored["layer_weight"])
        if "coop_ctx" in restored:  # a checkpoint of CoOp training
            tm.coop_ctx = restored["coop_ctx"].to(tm.device)

    if config.fetch and config.fetch_path:
        apply(restore_params(config.fetch_path))
    if config.load:
        path = (config.load_path if config.load_path != "none"
                else os.path.join(config.save_path, f"clip_{config.from_epoch}"))
        apply(restore_params(path))
        print("successfully loaded", flush=True)
    return tm


def _image_source(config: Config, resolution: int, grouped=None, split: str = ""):
    """Synthetic images, the split's decode cache (built on first use), or
    the image files under ``--image_root``."""
    if config.synthetic:
        return SyntheticImageSource(resolution)
    if config.decode_cache and grouped is not None:
        from .data.decode_cache import open_or_build

        return open_or_build(os.path.join(config.decode_cache, split or "default"),
                             grouped, resolution, image_root=config.image_root,
                             num_procs=config.num_proc_workers)
    return FileImageSource(resolution, config.image_root)


def _grouped_split(config: Config, split: str, candidates, splits) -> Dict[str, list]:
    """``{class: [image paths]}`` of ``split`` for the candidate classes:
    synthetic names, the binary ``{split}_split.idx`` index when it exists
    beside ``--split_path``, else ``{split}_split.json``; ``--k_shots`` caps
    the unseen classes (``driver.py:125-149``)."""
    if config.synthetic:
        per = config.synthetic_images_per_class
        grouped = {c: [f"{c}/{j}.jpg" for j in range(per)] for c in candidates}
    else:
        base = os.path.join(os.path.dirname(config.split_path), f"{split}_split")
        if os.path.isdir(base + ".idx"):
            from .data.manifest_index import MmapManifest

            grouped = MmapManifest(base + ".idx").grouped(candidates)
        else:
            grouped = load_manifest(base + ".json", candidates)
    if config.k_shots > 0:
        grouped = kshot_subsample(grouped, unseen=splits["rest"], k_shots=config.k_shots,
                                  seed=config.seed)
    return grouped


def run_test(config: Config, tm: TreeModel, splits, logger: RunLogger) -> Dict[str, float]:
    """Zero-shot evaluation (reference ``test()``, ``main.py:104-222``)."""
    require_ported(config)
    dev = tm.device
    if config.coop:
        from .eval.bank import build_bank_ids

        static, ctx = tm.coop_setup(config.seed)
        if tm.coop_ctx is not None:
            ctx = tm.coop_ctx  # trained context from run_train or a checkpoint
        bank = build_bank_ids({"clip": tm.model, "coop_ctx": ctx}, tm.n_pad,
                              tm.coop_text_fn(static), chunk=min(512, tm.n_pad),
                              out_dtype=tm.dtype, device=dev)
    else:
        bank = tm.update_classifier()
    bank_s = tm.sort_bank(bank)

    grouped = _grouped_split(config, config.data_split_test, splits[config.data_test], splits)
    loader = GroupedTestLoader(
        grouped,
        {c: tm.hier.name_to_id[c] for c in grouped},
        _image_source(config, tm.clip_cfg.image_resolution, grouped, config.data_split_test),
        config.test_batch_size,
        num_threads=config.num_workers,
        num_procs=config.num_proc_workers,
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


def run_train_flat(config: Config, tm: TreeModel, splits, logger: RunLogger) -> Any:
    """Flat fine-tuning, ``--training_method flat`` (``hgr_tpu/driver.py:
    257-334``): accepted but never run by the reference (``main.py:55``);
    here the CLIP-flat step over shuffled multi-class batches, cross-entropy
    over the seen classes' prompts, the global-norm clip, then AdamW on the
    cosine schedule over the CLIP tensors alone (``layer_weight`` stays).
    A checkpoint each epoch; ``--resume`` does not apply. Returns the final
    TrainState."""
    from contextlib import closing

    from .baselines.clip_flat import make_flat_train_step
    from .data import FlatTrainLoader
    from .train import TrainState
    from .train.trainer import Optimizer
    from .utils.checkpoint import AsyncCheckpointSaver
    from .utils.preempt import GracefulShutdown

    require_ported(config)
    dev = tm.device
    grouped = _grouped_split(config, config.data_split_train, splits[config.data_train],
                             splits)
    seen_ids = tm.hier.ids(splits["train"])
    seen_pos = {int(c): i for i, c in enumerate(seen_ids)}
    loader = FlatTrainLoader(
        grouped,
        {c: tm.hier.name_to_id[c] for c in grouped},
        _image_source(config, tm.clip_cfg.image_resolution, grouped, config.data_split_train),
        config.batch_size,
        seed=config.seed,
        num_threads=config.num_workers,
        num_procs=config.num_proc_workers,
    )
    seen_tokens = torch.as_tensor(tm.node_tokens[seen_ids], device=dev).long()
    # optax.chain(clip_by_global_norm, adamw(cosine_lr)) over {"clip"} alone,
    # with no MultiSteps (driver.py:287-292)
    tx = Optimizer(config.replace(accum_steps=1), config.epochs * max(1, len(loader)),
                   {"clip": "clip"})
    params = {"clip": tm.model}
    opt = tx.init(params)
    state = TrainState(params={"clip": tm.model, "layer_weight": tm.layer_weight}, opt_state=opt)
    step = make_flat_train_step(tx, dtype=tm.dtype)
    logger.log_config(config)
    with AsyncCheckpointSaver(keep=config.keep_checkpoints) as saver, \
            GracefulShutdown() as shutdown, closing(loader):
        for epoch in range(config.from_epoch + 1, config.epochs):
            loader.set_epoch(epoch)  # restart-deterministic shuffles
            for i, (images, labels, _valid) in enumerate(loader):
                # a label outside the seen classes counts as seen class 0, as
                # in the JAX package (driver.py:306)
                labels = torch.as_tensor([seen_pos.get(int(x), 0) for x in labels], device=dev)
                params, opt, loss = step(params, opt, torch.from_numpy(images).to(dev),
                                         seen_tokens, labels)
                if i % config.print_freq == 0:
                    logger.log_train(epoch, i, len(loader), float(loss))
                if shutdown.requested:
                    break  # SIGTERM: the checkpoint below still runs
            state.step = (epoch + 1) * len(loader)
            saver.save(config.save_path, epoch, state)
            logger.log_text(f"Model saved. epoch={epoch}")
            if shutdown.requested:
                logger.log_text(f"preempted (SIGTERM): saved epoch={epoch}")
                break
            if config.test_after_train:
                run_test(config, tm, splits, logger)
    return state


def run_train(config: Config, tm: TreeModel, splits, logger: RunLogger) -> Any:
    """OM fine-tuning (reference ``train()`` + driver, ``main.py:72-101,
    225-258``); returns the final TrainState. With ``--coop`` the text path
    is the prompt learner and ``--coop_train`` labels what trains
    (``hgr_tpu/driver.py:370-382``)."""
    from .models.layers import attention_scores
    from .train import (
        NegativeSampler,
        ScheduleBuilder,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    require_ported(config)
    grouped = _grouped_split(config, config.data_split_train, splits[config.data_train],
                             splits)
    loader = GroupedTrainLoader(
        grouped,
        {c: tm.hier.name_to_id[c] for c in grouped},
        _image_source(config, tm.clip_cfg.image_resolution, grouped, config.data_split_train),
        config.batch_size,
        n_episodes=config.n_episodes,
        seed=config.seed,
        num_threads=config.num_workers,
        serial_batches=config.serial_batches,
        num_procs=config.num_proc_workers,
    )
    steps_per_epoch = loader.n_episodes
    text_fn = extra_params = extra_labels = None
    if config.coop:
        static, ctx = tm.coop_setup(config.seed)
        # under autograd: the plain attention, as for the standard text path
        text_fn = tm.coop_text_fn(static, attn_fn=attention_scores)
        extra_params = {"coop_ctx": ctx}
        extra_labels = {
            "ctx": {"clip": "frozen", "coop_ctx": "clip"},
            "clip": {"coop_ctx": "frozen"},
            "both": {"coop_ctx": "clip"},
        }[config.coop_train]
    tx = make_optimizer(config, config.epochs * steps_per_epoch, extra_labels=extra_labels)
    state = init_train_state(tm.model, tm.layer_weight, tx, extra_params=extra_params)
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
    # frozen groups take no gradient, so their backward never runs (ctx-only
    # CoOp skips the whole image tower's)
    frozen = tuple(k for k, v in (extra_labels or {}).items() if v == "frozen")
    step_fn = make_train_step(config, tx, dtype=tm.dtype, text_fn=text_fn, frozen=frozen)

    sampler = NegativeSampler(tm.hier, tm.train_index, config.num_compare, k=config.k,
                              seed=config.seed,
                              topk_window="both" if config.coop else "below",
                              exclu_bro=config.exclu_bro)
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
    from .utils.profiling import TraceWindow

    tracer = TraceWindow(config.trace_dir)
    try:
        return _epoch_loop(config, tm, splits, logger, tracer, state, step_fn, sampler,
                           loader, node_tokens, prefetch_steps, steps_per_epoch, resume_skip)
    finally:
        tracer.close()
        loader.close()


def _epoch_loop(config, tm, splits, logger, tracer, state, step_fn, sampler, loader,
                node_tokens, prefetch_steps, steps_per_epoch, resume_skip=0):
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
                    tracer.before(i)
                    state, loss = step_fn(state, torch.from_numpy(images).to(dev), node_tokens,
                                          sched_to_device(sched_host, dev))
                    tracer.after(i, loss)
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
            if config.coop:
                tm.coop_ctx = state.params["coop_ctx"]
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


def main(argv=None, device=None) -> Any:
    """``python -m hgr_tpu_torch [flags]``; ``device`` (from Python only)
    replaces ``cuda:{--device}``."""
    config = Config.from_args(argv)
    hier, splits = build_hierarchy(config)
    print("Creating models", flush=True)
    tm = build_model(config, hier, splits, device=device)
    logger = RunLogger(config.save_path)
    if config.train:
        print("Training.", flush=True)
        if config.training_method == "flat":
            return run_train_flat(config, tm, splits, logger)
        return run_train(config, tm, splits, logger)
    print("Direct testing.", flush=True)
    return run_test(config, tm, splits, logger)
