"""What every driver shares: the run's context, its outcome, host ranges."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

import torch

from ..system import Program, SetupClock, build_program, weight_seed
from ..trace import Tracer


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)  # per-layer readings
    work: Dict[str, float] = field(default_factory=dict)         # counted in the window
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak: int = 0
    notes: List[str] = field(default_factory=list)


@dataclass
class RunContext:
    cell: str
    cfg: Dict
    family: ModuleType            # the configuration's (hbench/family.py)
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    clock: SetupClock
    tracer: Tracer = None
    t_window: Optional[float] = None

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(self.trace)

    @property
    def weight_seed(self) -> int:
        return weight_seed(self.seed)

    def build(self, keep_weights: bool = False) -> Program:
        return build_program(self.family, self.cfg, self.seed, self.device, self.clock,
                             keep_weights)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A named host range of the traced run (nothing otherwise)."""
        return self.tracer.span(name)

    @property
    def trace_seconds(self) -> float:
        """Length of the traced window that follows the measured one."""
        return min(self.traffic.get("trace_seconds", self.seconds), self.seconds)

    def window_start(self, traced: bool = False) -> float:
        """Open a window; set-up ends at the first. The traced window, which
        a ``--trace 1`` run adds after the measured one, starts the
        profiler first: its cost on the host stays out of the measured
        window, whose host spans and rates the per-layer metrics read."""
        self.sync()
        if traced:
            self.tracer.start()
        t = time.perf_counter()
        if self.t_window is None:
            self.t_window = t
        return t

    def window_end(self, traced: bool = False) -> None:
        """Close a window; the caller has synchronised."""
        if traced:
            self.tracer.stop()

    def memory_peak(self) -> int:
        """The process's peak of allocated device memory, set-up included."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def free_program(prog: Program) -> None:
    """Drop the program's state before the reference runs on the card."""
    prog.tm.model = None
    prog.tm = None
    prog.weights.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
