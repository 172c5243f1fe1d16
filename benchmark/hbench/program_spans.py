"""The program's own spans, as the per-layer readers read them.

``hgr_tpu_torch.utils.profiling.annotate`` records a span only while a
``torch.profiler`` runs, so in a ``--trace 1`` run the recorder holds the
traced window's spans and nothing else. Each span has a name, the index
of its parent, its host time (``host_ms``) and its device time between two
CUDA events on its stream (``device_ms``, None off the card). A program
without the recorder, or a run without a trace, gives no span, and every
function here then returns None.
"""

from __future__ import annotations

from typing import List, Optional


def spans() -> List:
    """The recorded spans, or none where the program has no recorder."""
    from hgr_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded_spans", None)
    return list(read()) if read is not None else []


def mean(name: str, field: str = "device_ms", parent: Optional[str] = None) -> Optional[float]:
    """Mean ``field`` of the spans named ``name`` (under a span named
    ``parent``, where given) that have it."""
    got = spans()
    vals = [getattr(s, field) for s in got
            if s.name == name and getattr(s, field) is not None
            and (parent is None or (s.parent is not None and got[s.parent].name == parent))]
    return sum(vals) / len(vals) if vals else None


def ops_per(name: str, trace) -> Optional[float]:
    """Device operations in the traced window (kernels, copies, sets) over
    the number of spans named ``name``."""
    if trace is None:
        return None
    n = sum(1 for s in spans() if s.name == name)
    return len(trace.device) / n if n else None
