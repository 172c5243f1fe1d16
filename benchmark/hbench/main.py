"""One run of one cell: set-up, the window, the check, the result line."""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

from . import check, spec
from .system import SetupClock

ROOT = Path(__file__).resolve().parents[2]
# top-level modules no run may hold once its window has closed, compared
# whole: the JAX package and JAX, and the program's retired benchmarks
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "orbax", "hgr_tpu", "bench",
                 "chip_smoke", "tools"}
FORBIDDEN_FULL = {"hgr_tpu_torch.bench"}


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_TOP or m in FORBIDDEN_FULL)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return "# card: " + r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"# card: nvidia-smi unavailable ({e})"


def main(argv, t_start: float, t_imported: float) -> int:
    """One run; ``t_start`` is the process's first clock reading and
    ``t_imported`` the one after the harness's imports (torch with them)."""
    import torch

    args = parse(argv)
    cell = spec.load_cell(args.workload, ROOT)
    clock = SetupClock(t_start)
    clock.parts["harness_imports"] = t_imported - t_start
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from .drivers.base import RunContext

    dev = torch.device("cuda", 0)
    with clock.part("cuda_init"):
        torch.zeros(1, device=dev)
    rc = RunContext(cell=cell.name, cfg=cell.cfg, family=cell.family, traffic=cell.traffic,
                    seed=args.seed % 2**63, seconds=args.seconds, trace=bool(args.trace),
                    device=dev, clock=clock)
    driver = importlib.import_module(f"hbench.drivers.{cell.traffic['driver']}")
    out = driver.run(rc)
    summary = rc.tracer.reduce()
    bad = forbidden_modules()
    if bad:
        print(f"modules this run may not hold are loaded: {bad}", file=sys.stderr)
        return 3
    return report(args, cell, rc, out, summary, torch.cuda.get_device_name(0))


def report(args, cell, rc, out, summary, kind: str) -> int:
    """Print the stderr lines and the result line; 0 when printed."""
    setup_s = rc.t_window - rc.clock.t_start
    metrics: Dict[str, Dict] = {}
    if not args.trace:
        values = dict(out.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = spec.ReadContext(spans=out.spans, work=out.work, trace=summary)
        for m in cell.per_layer:
            v = spec.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": out.memory_peak}
    result = {"correct": check.within(out.checks, cell.limits) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                        for k, v in out.checks.items()}
    err = sys.stderr
    print(rc.clock.line(rc.t_window), file=err)
    for line in out.notes:
        print(line, file=err)
    print(card_line(), file=err)
    for k, v in out.checks.items():
        print(f"check {k} {v!r} limit {cell.limits.get(k)!r}", file=err)
    err.flush()
    print(json.dumps(result), flush=True)
    return 0
