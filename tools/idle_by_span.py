"""Where the card idles, by the program's own spans, for one benchmark cell.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> [--seconds 10]
        [--root CHECKOUT] [--out FILE.json]

Runs the cell's driver as ``benchmark/run.py --trace 1`` does (a measured
window, then a traced one under ``torch.profiler``), keeps the profiler's
events before the harness reduces them, and passes the benchmark's host
ranges together with the program's spans (``hgr_tpu_torch.utils.profiling.
recorded_spans``, the driving thread's, as ``(t0_ns, t1_ns, name)``) to
``hbench.trace.reduce_events`` as it is. A program span is named by the
benchmark range it opened in and its path from the outermost span, e.g.
``eval.head > tree.head/head.metrics``. Prints, in the traced window: the
idle share (as ``device.idle_pct.*`` reads it); each benchmark range's
count, mean length and period from start to start (a step's time in the
traced window, the spans' cost included); the idle seconds by the
benchmark's ranges alone (the result line's ``breakdown.idle_gaps``) and
by the innermost program span; device ops per benchmark range and per
program span (``--out`` also keeps each op name's count); each span path's
count and mean host and device ms; and the cost of one span off and on
(``annotate``, with the profiler running and CUDA initialised). ``--root``
runs another checkout's benchmark and program (a program without the
recorder gives no spans).
Needs a CUDA card; runs nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import threading
import time
from collections import Counter, defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def program_spans(ranges):
    """The driving thread's spans as ``(t0_ns, t1_ns, name)``, each named
    ``<benchmark range> > <path>``, and each path's (count, mean host ms,
    mean device ms); nothing from a program without the recorder."""
    try:
        from hgr_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return [], {}
    spans = recorded_spans()
    main = threading.main_thread().ident
    paths = []
    for s in spans:
        p = s.name if s.parent is None else paths[s.parent] + "/" + s.name
        paths.append(p)
    ranges = sorted(ranges)
    out, stats = [], defaultdict(lambda: [0, 0.0, 0.0, 0])
    for s, path in zip(spans, paths):
        if s.t1_ns is None:
            continue
        st = stats[path]
        st[0] += 1
        st[1] += s.host_ms
        if s.device_ms is not None:
            st[2] += s.device_ms
            st[3] += 1
        if s.thread != main:
            continue
        outer = next((n for a, b, n in ranges if a <= s.t0_ns < b), "outside the ranges")
        out.append((s.t0_ns, s.t1_ns, f"{outer} > {path}"))
    return out, {p: {"count": n, "host_ms": h / n, "device_ms": d / nd if nd else None}
                 for p, (n, h, d, nd) in stats.items()}


def range_stats(bounds):
    """A benchmark range's count, mean length, and mean distance from one
    start to the next (the step's period, where the range opens each step),
    in ms on the host clock."""
    bounds = sorted(bounds)
    n = len(bounds)
    period = (bounds[-1][0] - bounds[0][0]) / (n - 1) * 1e-6 if n > 1 else None
    return {"count": n, "mean_ms": sum(b - a for a, b in bounds) / n * 1e-6,
            "period_ms": period}


def span_cost(n: int = 20000):
    """Mean cost of one empty span in µs: off (no profiler) and on (a CUDA
    profiler running, so with ``record_function`` and two CUDA events)."""
    import torch

    from hgr_tpu_torch.utils import profiling

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("span.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = loop()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        on = loop()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    profiling.clear_spans()
    return {"off_us": off, "on_us": on}


def collect(rc, driver, reduce_events):
    """Run the cell's driver with a trace; the window's summary by the
    benchmark's ranges alone and with the program's spans."""
    out = driver.run(rc)
    tr = rc.tracer
    events = tr.prof.profiler.kineto_results.events()
    w0, w1 = tr.window
    ranges = list(tr.spans)
    spans, stats = program_spans(ranges)
    by_range = reduce_events(events, w0, w1, ranges)
    by_span = reduce_events(events, w0, w1, ranges + spans)
    n_ops = len(by_range.device)
    counts = defaultdict(int)
    starts = defaultdict(list)
    for t0, t1, name in ranges:
        counts[name] += 1
        starts[name].append((t0, t1))
    return {
        "attempted": out.attempted, "failed": out.failed, "checks": out.checks,
        "window_s": by_range.window_s, "busy_s": by_range.busy_s,
        "idle_s": by_range.window_s - by_range.busy_s,
        "idle_pct": 100.0 * (1.0 - by_range.busy_s / by_range.window_s),
        "ranges": {k: range_stats(v) for k, v in sorted(starts.items())},
        "device_ops": n_ops,
        "op_counts": dict(sorted(Counter(n for n, _ in by_range.device).items())),
        "ops_per_range": {k: n_ops / v for k, v in sorted(counts.items())},
        "ops_per_span": {p: n_ops / st["count"] for p, st in sorted(stats.items())},
        "idle_by_range": by_range.top_gaps(50),
        "idle_by_span": by_span.top_gaps(50),
        "spans": stats,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser("tools/idle_by_span.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--root", default=str(REPO), help="the checkout whose benchmark and program run")
    p.add_argument("--out", default="", help="also write the result here as JSON")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(root / "benchmark"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from hbench import spec
    from hbench.drivers.base import RunContext
    from hbench.main import card_line
    from hbench.system import SetupClock
    from hbench.trace import reduce_events

    cell = spec.load_cell(args.workload, root)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    rc = RunContext(cell=cell.name, cfg=cell.cfg, family=cell.family, traffic=cell.traffic,
                    seed=args.seed % 2**63, seconds=args.seconds, trace=True, device=dev,
                    clock=SetupClock(time.perf_counter()))
    driver = importlib.import_module(f"hbench.drivers.{cell.traffic['driver']}")
    res = collect(rc, driver, reduce_events)
    res.update(workload=args.workload, seed=args.seed, root=str(root), card=card_line())
    try:
        res["span_cost_us"] = span_cost()
    except (ImportError, AttributeError):  # a program without the recorder
        res["span_cost_us"] = None
    print(res["card"])
    print(f"{args.workload} seed {args.seed}: window {res['window_s']:.4f} s, busy "
          f"{res['busy_s']:.4f} s, idle {res['idle_s']:.4f} s; {res['device_ops']} device ops; "
          f"span cost {res['span_cost_us']}")
    print(f"idle {res['idle_pct']:.4f}% (as device.idle_pct.*)")
    print("ranges (count, mean ms, period ms):")
    for name, st in res["ranges"].items():
        print(f"  {st['count']:6d}  {st['mean_ms']:10.4f}  {st['period_ms']}  {name}")
    print("ops per range:", json.dumps(res["ops_per_range"]))
    print("ops per span:", json.dumps(res["ops_per_span"]))
    print("idle by range (s):")
    for name, s in res["idle_by_range"]:
        print(f"  {s:.6f}  {name}")
    print("idle by innermost program span (s):")
    for name, s in res["idle_by_span"]:
        print(f"  {s:.6f}  {name}")
    print("spans (count, mean host ms, mean device ms):")
    for path, st in sorted(res["spans"].items()):
        print(f"  {st['count']:6d}  {st['host_ms']:10.4f}  "
              f"{st['device_ms'] if st['device_ms'] is None else round(st['device_ms'], 4)}  "
              f"{path}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
