"""Graceful shutdown for preemptible workers (the port's copy of
``hgr_tpu/utils/preempt.py:19-47``).

A scheduler that preempts a worker sends SIGTERM and gives it a grace
window. The train loop turns SIGTERM into a stop at a step boundary: it
finishes the step in flight, checkpoints params, optimizer state and step,
logs where it stopped, and exits cleanly, so that ``--resume True``
continues.
"""

from __future__ import annotations

import signal
from typing import Iterable


class GracefulShutdown:
    """Context manager that latches shutdown signals instead of dying.

    Inside the context, SIGTERM (by default) sets :attr:`requested`; loops
    poll it at step boundaries. The previous handlers come back on exit.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._old = {}
        self.requested = False

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self._signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:
                # not the main thread (e.g. a test harness): poll-only mode
                pass
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
