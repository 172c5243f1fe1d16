"""``BENCHMARK.json`` and the files it names, found by name.

A cell is an entry of ``workloads``. Its configuration is the file that
the ``configs`` entry of its name gives; its traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module in
``hbench/drivers`` that runs it and whose ``tiny`` holds the sizes of its
CPU test; ``benchmark/limits/<cell>.json`` holds the limit of each number
the cell checks (``limits``), the limits at the CPU test's sizes
(``tiny_limits``) and the faults the cell can have (``faults``, of
``hbench/faults.py``); a per-layer metric's reader is
``benchmark/metrics/<metric>.py``; a configuration's reference family is
``benchmark/families/<family>.py``, which its ``"family"`` key names
(``clip`` where it names none; ``hbench/family.py`` lists what a family
defines), found by its path under the checkout the cell was loaded
from, so that a copy of ``benchmark/`` finds its own. Adding a cell, a configuration, a mix of a known driver, a
metric or a family adds files and entries and edits none: a family is
added by its file and a configuration that names it. Two things stay in
the harness's code, whatever the family: the keys of a configuration that
the drivers read (``arch``, ``dtype``, ``embed_dim``, ``classes``,
``vision.image_resolution``, ``text.context_length`` and
``text.vocab_size``), and ``drivers/refresh.py``'s name for the text
tower's positional embedding, ``positional_embedding``, OpenAI's key: a
family whose state dict names it otherwise cannot run the refresh mix.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from . import family

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict
    family: ModuleType             # the configuration's family (hbench/family.py)
    traffic: Dict
    limits: Dict[str, float]
    tiny_limits: Dict[str, float]  # at the CPU test's sizes
    faults: List[str]              # the kinds of fault the cell can have
    end_to_end: List[Dict]     # the end-to-end metrics this cell reports
    per_layer: List[Dict]      # the per-layer metrics this cell reports


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        cfg = json.load(f)
    bench_dir = root / "benchmark"
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), cfg=cfg, family=family.load(cfg, bench_dir),
        traffic=traffic, limits=limits["limits"],
        tiny_limits=limits["tiny_limits"], faults=limits["faults"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "hbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class ReadContext:
    """What a per-layer reader reads: host and CUDA-event spans in ms by
    name, the work the window's inputs needed, and the device trace."""

    spans: Dict[str, List[float]]
    work: Dict[str, float]
    trace: Optional[object]    # trace.TraceSummary, or None off the card
