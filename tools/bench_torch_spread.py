#!/usr/bin/env python3
"""Run ``python -m hgr_tpu_torch.bench`` several times on one card and print
each key's median and range.

    python3 tools/bench_torch_spread.py [--runs 3] [--out runs/bench_spread]

Each run is a process of its own, as a user starts it; its whole output
goes to ``<out>/run<i>.log``. The last line is one JSON object: the card's
``nvidia-smi`` name and power limit, each run's seconds of command, and for
the headline (``value``) and every numeric key of ``extra`` the median,
min, max and the values in run order. Any run that fails ends the script
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "bench_spread"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"# {smi}", flush=True)
    lines, seconds = [], []
    for i in range(args.runs):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "hgr_tpu_torch.bench"], cwd=REPO,
                           capture_output=True, text=True)
        seconds.append(round(time.perf_counter() - t0, 1))
        with open(os.path.join(args.out, f"run{i}.log"), "w") as f:
            f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
        if p.returncode != 0:
            print(p.stdout[-3000:] + p.stderr[-3000:], flush=True)
            return 1
        lines.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(f"# run {i}: {seconds[-1]} s; {json.dumps(lines[-1])}", flush=True)
    rows = [dict(line["extra"], value=line["value"]) for line in lines]
    keys = [k for k, v in rows[0].items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    spread = {}
    for k in keys:
        vals = [r[k] for r in rows]
        spread[k] = {"median": statistics.median(vals), "min": min(vals), "max": max(vals),
                     "runs": vals}
    print(json.dumps({"card": smi, "seconds": seconds, "spread": spread}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
