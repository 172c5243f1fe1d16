"""Tests of the benchmark's harness, on the CPU at tiny sizes.

Run from the checkout's root: ``python -m pytest benchmark/tests -q``.
Tests marked ``chip`` need a CUDA card and skip without one; on the card:
``python -m pytest benchmark/tests -q -m chip``.
"""

import json
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def load_json(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def tiny_run_context(cell_name, seed=2**31 + 7, seconds=0.5, root=ROOT):
    """(driver module, limits at tiny sizes, RunContext) of a cell at tiny
    sizes on the CPU: its configuration cut to TEST sizes by its family's
    ``tiny`` (the published widths run only on the card), its traffic
    under the mix's ``tiny`` sizes, its limits file's ``tiny_limits``
    (each above the sound program's largest reading at those sizes and
    below the control's and the faults' smallest, from CPU runs on three
    seeds, as the cells' own limits are set at the published sizes)."""
    import importlib
    from pathlib import Path

    import torch
    from hbench import spec
    from hbench.drivers.base import RunContext
    from hbench.system import SetupClock

    cell = spec.load_cell(cell_name, Path(root))
    traffic = dict(cell.traffic, **cell.traffic["tiny"])
    assert set(cell.tiny_limits) == set(cell.limits)
    driver = importlib.import_module(f"hbench.drivers.{traffic['driver']}")
    return driver, cell.tiny_limits, RunContext(
        cell=cell_name, cfg=cell.family.tiny(cell.cfg), family=cell.family, traffic=traffic,
        seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
        clock=SetupClock(time.perf_counter()))
