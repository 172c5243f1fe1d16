"""The device trace of a ``--trace 1`` run, reduced to what readers need.

``torch.profiler`` records, through CUPTI, every kernel, copy and set on
the card; it records no host operators, whose cost would slow the host
path it measures. The host's side is the benchmark's own ranges around
its calls into the program (:meth:`Tracer.span`), on the clock that the
profiler's timestamps share (``time.time_ns``). The traced window is the
measured window. From these come the busy time (the union of the device's
intervals), each device op's time by name, and the idle gaps, each named
by the benchmark's range that was open at its middle: what the host was
doing while the card waited.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

OUTSIDE = "harness, between calls"


def _kernel_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, and its
    template and parameter lists."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds) per op
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host range, seconds)

    def time_of(self, prefix: str) -> float:
        """Seconds of device time of the ops whose name starts with ``prefix``."""
        return sum(s for n, s in self.device if n.startswith(prefix))

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s in self.device:
            tot[name] += s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s in self.idle_gaps:
            tot[name] += s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """The profiler over the window, and the benchmark's host ranges, when
    ``enabled``; otherwise it records nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.spans: List[Tuple[int, int, str]] = []
        self.window: Optional[Tuple[int, int]] = None
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.prof is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def start(self) -> None:
        """Start the profiler; the window opens when this returns."""
        if not self.enabled:
            return
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.window = (time.time_ns(), 0)

    def stop(self) -> None:
        """Close the window (the caller has synchronised) and the profiler."""
        if self.prof is None:
            return
        self.window = (self.window[0], time.time_ns())
        self.prof.stop()

    def reduce(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        self.summary = reduce_events(events, *self.window, self.spans)
        self.prof = None
        return self.summary


def reduce_events(events, w0: int, w1: int, spans: List[Tuple[int, int, str]]) -> TraceSummary:
    """Busy time, device ops and named idle gaps in the window [w0, w1] (ns)
    of a list of kineto events, the gaps named by ``spans``."""
    dev = []
    for ev in events:
        if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if e > w0 and s < w1:
                dev.append((max(s, w0), min(e, w1), ev.name()))
    dev.sort()
    ops = [(_kernel_name(n), (e - s) * 1e-9) for s, e, n in dev]
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_s = cur_e = w0
    for s, e, _ in dev:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < w1:
        gaps.append((cur_e, w1))
    # name each gap by the innermost range open at its middle
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    named: List[Tuple[str, float]] = []
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        named.append((stack[-1][2] if stack else OUTSIDE, (g1 - g0) * 1e-9))
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device=ops,
                        idle_gaps=named)
