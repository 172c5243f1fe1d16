"""A cell run on the card with one fault planted in the program's timed
path (``hbench/faults.py``), on each seed: the numbers it reads beside the
cell's limits. ``correct`` has to come out false.

    python3 benchmark/scripts/faults.py --workload rn50.om-train-b256 \
        --fault half_batch_train --seeds 1,2,3 --seconds 2
"""

import argparse
import importlib
import json
import time
from pathlib import Path

import _path  # noqa: F401

import torch  # noqa: E402
from hbench import check, faults, spec  # noqa: E402
from hbench.drivers.base import RunContext  # noqa: E402
from hbench.system import SetupClock  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    cell = spec.load_cell(a.workload, Path(_path.ROOT))
    driver = importlib.import_module(f"hbench.drivers.{cell.traffic['driver']}")
    faults.plant(setattr, a.fault)
    for seed in (int(s) for s in a.seeds.split(",")):
        rc = RunContext(cell=cell.name, cfg=cell.cfg, family=cell.family, traffic=cell.traffic,
                        seed=seed % 2**63, seconds=a.seconds, trace=False,
                        device=torch.device("cuda", 0), clock=SetupClock(time.perf_counter()))
        out = driver.run(rc)
        print(json.dumps({"workload": a.workload, "fault": a.fault, "seed": seed,
                          "not_correct": not check.within(out.checks, cell.limits),
                          "checks": {k: {"value": v, "limit": cell.limits.get(k)}
                                     for k, v in out.checks.items()},
                          "notes": out.notes}), flush=True)


if __name__ == "__main__":
    main()
