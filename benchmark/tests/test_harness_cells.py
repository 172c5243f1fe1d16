"""The harness finds every cell by name, runs each cell's traffic and its
reference at a tiny size, writes no device number off the card, and comes
out not correct when the timed path is broken underneath."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from conftest import ROOT, load_json, tiny_run_context

BENCH = load_json("BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _driver(cell):
    import importlib

    return importlib.import_module(f"hbench.drivers.{cell.traffic['driver']}")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist(name):
    """Each cell names a configuration, a traffic mix of a known driver,
    limits for every number it checks, and readers for its metrics; it
    reports setup_s, another end-to-end metric and a per-layer metric."""
    from hbench import spec

    cell = spec.load_cell(name, Path(ROOT))
    _driver(cell)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]))
        assert m["moves"] in e2e
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert set(cell.tiny_limits) == set(cell.limits) and cell.faults


def test_metric_workloads_and_names():
    import re

    name_re = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    cells = set(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name_re.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def _run_tiny(name, root=ROOT):
    """The cell's traffic through the program and its check through the
    reference, at TEST sizes on the CPU: correct under the cell's tiny
    limits, and no device metric reads a number without a trace."""
    from hbench import check, spec

    driver, limits, rc = tiny_run_context(name, root=root)
    out = driver.run(rc)
    assert out.attempted > 0 and out.failed == 0
    assert set(out.checks) == set(limits)
    assert all(np.isfinite(v) for v in out.checks.values())
    assert check.within(out.checks, limits), out.checks
    ctx = spec.ReadContext(spans=out.spans, work=out.work, trace=None)
    for m in spec.load_cell(name, Path(root)).per_layer:
        if m["source"] == "device_trace":
            assert spec.load_reader(m["name"])(ctx) is None, m["name"]


def test_added_cell_found_without_edits(tmp_path):
    """A cell added in a copy, by a new entry, a new mix and a new limits
    file only, loads and runs at TEST sizes with the harness as it is."""
    from hbench import spec

    shutil.copytree(Path(ROOT) / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "vitb16.eval-b64", "config": "clip-vit-b16",
                               "traffic": "eval-b64", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = dict(load_json("benchmark/traffic/eval-b512.json"), batch=64)
    (tmp_path / "benchmark" / "traffic" / "eval-b64.json").write_text(json.dumps(traffic))
    limits = load_json("benchmark/limits/vitb16.eval-b512.json")
    (tmp_path / "benchmark" / "limits" / "vitb16.eval-b64.json").write_text(json.dumps(limits))
    cell = spec.load_cell("vitb16.eval-b64", tmp_path)
    assert cell.cfg["arch"] == "ViT-B/16" and cell.traffic == traffic
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    _run_tiny("vitb16.eval-b64", root=tmp_path)


NEGATE_IMAGE = """

_encode_image = encode_image


def encode_image(sd, cfg, images, quant=None):
    return -_encode_image(sd, cfg, images, quant)
"""


@pytest.mark.parametrize("negated", [False, True], ids=["as_clip", "image_negated"])
def test_added_family_found_without_edits(tmp_path, negated):
    """A family added in a copy, by a family file, a configuration that
    names it, a cell entry and a limits file only, loads and runs at TEST
    sizes with the harness as it is, and is correct. The same family with
    its ``encode_image`` scaled by -1 comes out not correct: the check
    reads the configuration's family, not CLIP's by default."""
    from hbench import check, spec

    bench_dir = tmp_path / "benchmark"
    shutil.copytree(Path(ROOT) / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    source = (bench_dir / "families" / "clip.py").read_text()
    (bench_dir / "families" / "twin.py").write_text(source + (NEGATE_IMAGE if negated else ""))
    cfg = dict(load_json("benchmark/configs/clip-vit-b16.json"), name="twin-b16",
               family="twin")
    (bench_dir / "configs" / "twin-b16.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "twin-b16", "source": "test",
                             "file": "benchmark/configs/twin-b16.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "twin.eval-b512", "config": "twin-b16",
                               "traffic": "eval-b512", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = load_json("benchmark/limits/vitb16.eval-b512.json")
    (bench_dir / "limits" / "twin.eval-b512.json").write_text(json.dumps(limits))
    cell = spec.load_cell("twin.eval-b512", tmp_path)
    assert Path(cell.family.__file__) == bench_dir / "families" / "twin.py"
    if not negated:
        _run_tiny("twin.eval-b512", root=tmp_path)
        return
    driver, limits, rc = tiny_run_context("twin.eval-b512", root=tmp_path)
    out = driver.run(rc)
    assert out.checks["feat_err"] > limits["feat_err"], out.checks
    assert not check.within(out.checks, limits)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_tiny_on_cpu(name):
    """Each cell of BENCHMARK.json at TEST sizes on the CPU (``_run_tiny``)."""
    _run_tiny(name)


def _faults():
    from hbench import spec

    return [(c, f) for c in CELLS for f in spec.load_cell(c, Path(ROOT)).faults]


@pytest.mark.parametrize("name,fault", _faults())
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    """A run past the look for a card, with the timed path broken
    underneath, comes out not correct under the cell's own limits."""
    from hbench import check

    from hbench import faults

    faults.plant(monkeypatch.setattr, fault)
    driver, limits, rc = tiny_run_context(name)
    out = driver.run(rc)
    assert not check.within(out.checks, limits), (fault, out.checks)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_program(name):
    """At a tiny size the control (the reference at float8 in the program's
    place) reads at least three times the program's bf16 numbers on one of
    them; on the card at the cell's size it fails the limits
    (``test_control_fails_on_chip``)."""
    from hbench import reference

    driver, _, rc = tiny_run_context(name)
    prog = driver.run(rc).checks
    driver, _, rc = tiny_run_context(name)
    ctrl = driver.control(rc, reference.fp8)
    assert any(ctrl[k] >= 3 * max(prog[k], 1e-12) for k in prog), (prog, ctrl)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_chip(cuda_device, name):
    """The control at the cell's own size, on three seeds, reads one of its
    numbers over the cell's limit, so that it comes out not correct."""
    import time

    from hbench import check, reference, spec
    from hbench.drivers.base import RunContext
    from hbench.system import SetupClock

    cell = spec.load_cell(name, Path(ROOT))
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        rc = RunContext(cell=name, cfg=cell.cfg, family=cell.family, traffic=cell.traffic,
                        seed=seed, seconds=10.0, trace=False, device=cuda_device,
                        clock=SetupClock(time.perf_counter()))
        nums = _driver(cell).control(rc, reference.fp8)
        assert np.isfinite(list(nums.values())).all()
        assert check.over(nums, cell.limits), (seed, nums)
