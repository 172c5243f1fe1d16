#!/usr/bin/env python3
"""Where the PyTorch port's eval path spends device time, on one CUDA card.

    python3 tools/profile_torch_eval.py [--batches 3] [--trace-dir DIR]

Builds the chip_smoke configuration (RN50, the 18,278-class profiled
hierarchy padded to 18,432, batch 512), warms up, then traces with
``torch.profiler`` (1) one class-bank build and (2) ``--batches`` eval
steps on a device-resident batch. For each it prints the wall time, the
device busy time and share, and the device time by kernel family and by
kernel; with ``--trace-dir`` it also writes the Chrome traces there. Last,
it times the eval step's Hit@k count (the target's rank, ties in
``lax.top_k``'s order) beside the ``torch.topk`` it replaced, on one batch's
masked logits.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LEVEL_SIZES = [10, 800, 4000, 5000, 4000, 2500, 1000, 500, 250, 120, 60, 30, 8]
FAMILIES = [  # first match wins; matched against the lower-cased kernel name
    ("K1 attention", ("attention_fwd",)),
    ("convolution", ("conv", "cudnn", "implicit", "xmma_fprop", "sm90_xmma", "fprop")),
    ("matmul", ("gemm", "cutlass", "matmul", "splitk", "nvjet")),
    ("reduction / argmax / topk", ("reduce", "argmax", "topk", "sort", "scan", "radix")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat", "index",
                            "layer_norm", "softmax", "pool", "fill")),
]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def timed_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def report(tag: str, prof, wall_ms: float, untraced_ms: float, trace_dir: str) -> None:
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    by_fam = defaultdict(float)
    for e in events:
        by_fam[family(e.key)] += e.self_device_time_total
    print(f"[{tag}] wall {untraced_ms:.2f} ms untraced, {wall_ms:.2f} ms traced; "
          f"device busy {total_us / 1e3:.2f} ms "
          f"({total_us / 1e3 / wall_ms:.1%} of wall), {sum(e.count for e in events)} kernel launches")
    for fam, us in sorted(by_fam.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {fam:28s} {us / 1e3:9.3f} ms  {us / max(total_us, 1):6.1%}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{tag}]     {e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  {e.key[:110]}")
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, f"{tag}.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args()

    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.driver import build_model, synthetic_splits
    from hgr_tpu_torch.hierarchy import profiled_hierarchy

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_eval: CUDA is not available")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    cfg = Config(arch="RN50", synthetic=True, train=False)
    hier = profiled_hierarchy(LEVEL_SIZES, seed=0, cross_edges=40)
    splits = synthetic_splits(hier, cfg.seed)
    tm = build_model(cfg, hier, splits, device="cuda:0")
    dev = tm.device
    res = tm.clip_cfg.image_resolution
    images = torch.randn((512, res, res, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    valid = torch.ones(512, dtype=torch.bool, device=dev)
    target = int(tm.test_index[0])

    bank_s = tm.sort_bank(tm.update_classifier())          # warm-up: kernel build, cuDNN plans
    for _ in range(2):
        tm.eval_step_sorted(bank_s, images, target, valid)
    torch.cuda.synchronize()

    def bank():
        tm.update_classifier()

    def steps():
        for _ in range(args.batches):
            tm.eval_step_sorted(bank_s, images, target, valid)

    for tag, fn in (("bank_build", bank), (f"eval_step_x{args.batches}", steps)):
        untraced = timed_ms(fn)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed_ms(fn)
        report(tag, prof, wall, untraced, args.trace_dir)
    hit_at_k_cost(tm, bank_s, images, target, valid)
    return 0


def hit_at_k_cost(tm, bank_s, images, target, valid, reps=50) -> None:
    """Device ms of the Hit@k count of one eval step, against torch.topk."""
    from hgr_tpu_torch.eval.bank import bank_logits
    from hgr_tpu_torch.eval.metrics import NEG, TOPK, _rank_hits
    from hgr_tpu_torch.models.clip import encode_image

    tb = tm._sorted_tables
    with torch.inference_mode():
        logits = bank_logits(encode_image(tm.model, images, dtype=tm.dtype), bank_s)
        masked = torch.where(tb["test_s"][None, :], logits, NEG)
        col = torch.argmax((tb["order"] == target).to(torch.int8))
        for name, fn in (("rank count", lambda: _rank_hits(masked, col, TOPK, valid)),
                         ("torch.topk", lambda: torch.topk(masked, max(TOPK), dim=1))):
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            print(f"[hit@k] {name} over logits {tuple(masked.shape)}: "
                  f"{start.elapsed_time(end) / reps:.4f} ms a batch", flush=True)


if __name__ == "__main__":
    sys.exit(main())
