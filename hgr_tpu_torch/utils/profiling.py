"""The port's spans and trace capture (port of ``hgr_tpu/utils/profiling.py``;
the reference has none).

``annotate(name)`` is the one span: a context manager that records only
while a ``torch.profiler`` runs (``torch.autograd.profiler.
_is_profiler_enabled``, set by the profiler's ``start`` and cleared by its
``stop``, in every thread). Off, it reads that flag and does nothing else.
On, it records the span's name, its parent (the innermost span open on the
same thread), the thread, ``time.time_ns()`` at entry and exit (the clock
of the profiler's timestamps) and, where CUDA is initialised, a CUDA event
on the current stream at each; it also enters ``record_function(name)``,
so a Chrome trace shows the span on the kernels' timeline.
:func:`recorded_spans` gives the spans with their host and device times.

``TraceWindow`` traces train steps into a directory as a Chrome trace (the
driver's ``--trace_dir``), spans included.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1_000_000


@dataclass
class Span:
    """One recorded span. ``parent`` indexes :func:`recorded_spans`' list
    (None at a thread's top); ``t1_ns``, ``host_ms`` are None while it is
    open; ``device_ms`` runs from the stream reaching the entry event to it
    reaching the exit event (None without CUDA); ``events`` holds those two
    CUDA events until :func:`recorded_spans` resolves them."""

    name: str
    parent: Optional[int]
    thread: int
    t0_ns: int
    t1_ns: Optional[int] = None
    host_ms: Optional[float] = None
    device_ms: Optional[float] = None
    events: Optional[list] = field(default=None, repr=False, compare=False)


class _Recorder:
    """The process's spans, kept in memory up to ``MAX_SPANS`` (call
    :meth:`clear` with no span open)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[int]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def resolved(self) -> List[Span]:
        with self.lock:
            pending = [s for s in self.spans if s.events is not None and len(s.events) == 2]
            if pending:
                torch.cuda.synchronize()
                for s in pending:
                    s.device_ms = s.events[0].elapsed_time(s.events[1])
                    s.events = None
            return list(self.spans)

    def clear(self) -> None:
        with self.lock:
            self.spans, self.dropped = [], 0


_RECORDER = _Recorder()


def _cuda_event():
    """A timing event recorded on the current stream, or None where CUDA is
    not initialised."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class annotate:
    """``with annotate(name):`` a span of the program; records only while a
    ``torch.profiler`` runs (the module's docstring)."""

    __slots__ = ("name", "span", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if not _autograd_profiler._is_profiler_enabled:
            return self
        t0 = time.time_ns()
        rec = _RECORDER
        stack = rec.stack()
        self.span = None
        with rec.lock:
            if len(rec.spans) >= MAX_SPANS:
                rec.dropped += 1
            else:
                stack.append(len(rec.spans))
                self.span = Span(self.name, stack[-2] if len(stack) > 1 else None,
                                 threading.get_ident(), t0)
                rec.spans.append(self.span)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.span is not None:
            ev = _cuda_event()
            if ev is not None:
                self.span.events = [ev]
        return self

    def __exit__(self, *exc):
        if self.range is None:
            return False
        s = self.span
        if s is not None and s.events is not None:
            ev = _cuda_event()
            s.events = None if ev is None else [s.events[0], ev]
        self.range.__exit__(*exc)
        self.range = None
        if s is not None:
            s.t1_ns = time.time_ns()
            s.host_ms = (s.t1_ns - s.t0_ns) * 1e-6
            _RECORDER.stack().pop()
        return False


def recorded_spans() -> List[Span]:
    """The spans recorded so far, in the order they opened, with
    ``host_ms`` and ``device_ms`` (resolved after one synchronise)."""
    return _RECORDER.resolved()


def dropped_spans() -> int:
    """How many spans found the buffer full (``MAX_SPANS``)."""
    return _RECORDER.dropped


def clear_spans() -> None:
    """Empty the buffer."""
    _RECORDER.clear()


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
