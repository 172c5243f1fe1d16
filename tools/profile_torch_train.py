#!/usr/bin/env python3
"""Where the PyTorch port's OM train step spends its time, on one CUDA card.

    python3 tools/profile_torch_train.py [--steps 3] [--trace-dir DIR]

Builds ``chip_smoke.py``'s train configuration (RN50 in bf16 with remat,
batch 256, 256 negatives, the 18,278-class profiled hierarchy padded to
18,432) and one pair schedule of a deepest-level class. It prints:

1. the host's time to build a pair schedule (the driver builds them in a
   background thread, beside the device step), over a few classes;
2. the train step's wall time, untraced, over ``--steps`` steps on a
   device-resident batch;
3. the traced steps: device busy time and share, device time by kernel
   family and the largest kernels (and Chrome traces with ``--trace-dir``);
4. the step taken apart, each part timed alone by CUDA events: the image
   tower forward and backward, the text tower over the schedule's prompts
   forward and backward, and the optimizer update.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_eval import LEVEL_SIZES, report, timed_ms  # noqa: E402


def event_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, by CUDA events after one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args()

    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.driver import build_model, synthetic_splits
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.models.clip import encode_image, encode_text
    from hgr_tpu_torch.train import (NegativeSampler, ScheduleBuilder, freeze_params,
                                     init_train_state, make_optimizer, make_train_step,
                                     sched_to_device)

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: CUDA is not available")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    cfg = Config(arch="RN50", synthetic=True, train=True, remat=True, batch_size=256,
                 num_compare=256)
    hier = profiled_hierarchy(LEVEL_SIZES, seed=0, cross_edges=40)
    splits = synthetic_splits(hier, cfg.seed)
    tm = build_model(cfg, hier, splits, device="cuda:0")
    dev = tm.device

    sampler = NegativeSampler(hier, tm.train_index, cfg.num_compare, k=cfg.k, seed=cfg.seed)
    t0 = time.perf_counter()
    builder = ScheduleBuilder(hier, sampler, cfg.out_ratio, cfg.in_ratio, cfg.num_compare,
                              method=cfg.training_method, strategy=cfg.sample_strategy)
    print(f"[schedule] ScheduleBuilder set-up (max_pairs over every class): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; P = {builder.p_max}", flush=True)
    rng = np.random.default_rng(0)
    build_ms, prompts = [], []
    for target in rng.choice(tm.train_index, 8, replace=False):
        t0 = time.perf_counter()
        s = builder.build(int(target))
        build_ms.append((time.perf_counter() - t0) * 1e3)
        prompts.append((int(hier.depth[target]), len(np.unique(s.compare[s.compare_valid])),
                        len(s.unique)))
    print(f"[schedule] host ms per schedule {[round(x, 1) for x in build_ms]}, median "
          f"{float(np.median(build_ms)):.1f}; (depth, distinct prompts, encoded) {prompts}",
          flush=True)

    deep = int(hier.level(hier.max_depth)[0])
    sched = sched_to_device(builder.build(deep), dev)
    images = torch.randn((cfg.batch_size, 224, 224, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.as_tensor(tm.node_tokens, device=dev).long()
    tx = make_optimizer(cfg, 100)
    state = init_train_state(tm.model, tm.layer_weight, tx)
    step = make_train_step(cfg, tx, dtype=tm.dtype)
    print(f"[step] deepest class {deep}: {int(sched['unique'].numel())} prompts encoded, "
          f"P = {int(sched['pair_valid'].sum())} live pairs", flush=True)

    def steps():
        for _ in range(args.steps):
            step(state, images, tokens, sched)

    steps()  # warm-up: cuDNN plans, allocator
    torch.cuda.reset_peak_memory_stats(dev)
    untraced = timed_ms(steps)
    print(f"[step] {untraced / args.steps:.1f} ms a step untraced = "
          f"{cfg.batch_size * args.steps / untraced * 1e3:.1f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed_ms(steps)
    report(f"train_step_x{args.steps}", prof, wall, untraced, args.trace_dir)

    params = freeze_params(state.params, ())
    toks = tokens[sched["unique"]]

    def image_part():
        f = encode_image(params["clip"], images, dtype=tm.dtype, remat=True)
        f.float().square().sum().backward()

    def text_part():
        f = encode_text(params["clip"], toks, dtype=tm.dtype, remat=True)
        f.float().square().sum().backward()

    def optimizer_part():
        for t in tx.groups(params)["clip"] + [tm.layer_weight]:
            t.grad = torch.zeros_like(t)
        tx.update(params, state.opt_state)

    parts = {"image tower fwd+bwd": image_part, "text tower fwd+recompute+bwd": text_part,
             "optimizer (clip + AdamW + SGD)": optimizer_part}
    for name, fn in parts.items():
        print(f"[parts] {name:32s} {event_ms(fn, 3):8.2f} ms", flush=True)
        for t in tx.groups(params)["clip"] + [tm.layer_weight]:
            t.grad = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
