"""Profiling and tracing helpers (port of ``hgr_tpu/utils/profiling.py``;
the reference has none).

Over ``torch.profiler``: named ranges (``annotate``), a trace capture into
a directory as a Chrome trace (``capture_trace``, ``TraceWindow``, the
driver's ``--trace_dir``), and a step timer that waits for the card before
reading the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def annotate(name: str):
    """A named range in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _wait(result=None) -> None:
    """Wait for the work queued on the card (``result``'s device if it is a
    CUDA tensor); nothing to wait for on the CPU."""
    if isinstance(result, torch.Tensor) and result.device.type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(result.device if isinstance(result, torch.Tensor) else None)


def _start_trace() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``log_dir``; returns
    the file's path."""
    _wait()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def capture_trace(log_dir: Optional[str]):
    """Trace the block (CPU and, where there is one, CUDA activity) into a
    Chrome trace under ``log_dir``; nothing when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    prof = _start_trace()
    try:
        yield
    finally:
        _stop_trace(prof, log_dir)


class StepTimer:
    """Per-step wall-clock statistics; ``stop(result)`` waits for the card
    first, so a step's time is its device time and not its enqueue."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            _wait(result)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "items_per_sec": float(items_per_step / t.mean()),
        }


class TraceWindow:
    """Trace train steps [start, stop] (0-indexed within the run): call
    :meth:`before` ahead of each step and :meth:`after` behind it; nothing
    happens when ``log_dir`` is empty, so the driver calls it always
    (``--trace_dir``). ``paths`` lists the traces written."""

    def __init__(self, log_dir: Optional[str], start: int = 1, stop: int = 3):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self.paths: List[str] = []
        self._prof: Optional[torch.profiler.profile] = None
        self._done = False

    def before(self, i: int) -> None:
        # "not active" matters when an epoch ends before step ``stop``: the
        # next epoch's step ``start`` must not start a second trace
        if self.log_dir and not self._done and self._prof is None and i == self.start:
            self._prof = _start_trace()

    def after(self, i: int, result=None) -> None:
        if self._prof is not None and i >= self.stop:
            _wait(result)
            self._finish()

    def close(self) -> None:
        """Stop a trace still running (the run ended inside the window);
        call it from a ``finally`` so that short runs still write one."""
        if self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        self.paths.append(_stop_trace(self._prof, self.log_dir))
        self._prof = None
        self._done = True
