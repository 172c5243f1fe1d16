"""The control of a cell on the card: the reference one precision step
below the configuration's (float8 e4m3 for bf16) in the program's place,
judged as a run's outputs are, on each seed.

    python3 benchmark/scripts/control.py --workload rn50.eval-b512 --seeds 1,2,3

Prints one JSON line a seed with every number beside the cell's limit,
and the numbers that read over their limits: the control comes out not
correct, as it has to, when one does. (An eval cell's control reads no
``metric_excess``: the reference's head is exact given its features.)
"""

import argparse
import importlib
import json
import time
from pathlib import Path

import _path  # noqa: F401

import torch  # noqa: E402
from hbench import check, reference, spec  # noqa: E402
from hbench.drivers.base import RunContext  # noqa: E402
from hbench.system import SetupClock  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args()
    cell = spec.load_cell(a.workload, Path(_path.ROOT))
    driver = importlib.import_module(f"hbench.drivers.{cell.traffic['driver']}")
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        rc = RunContext(cell=cell.name, cfg=cell.cfg, family=cell.family, traffic=cell.traffic,
                        seed=seed % 2**63, seconds=a.seconds, trace=False,
                        device=torch.device("cuda", 0), clock=SetupClock(t))
        nums = driver.control(rc, reference.fp8)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": "fp8",
                          "over": check.over(nums, cell.limits),
                          "checks": {k: {"value": v, "limit": cell.limits.get(k)}
                                     for k, v in nums.items()},
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
