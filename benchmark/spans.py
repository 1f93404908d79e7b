"""The program's spans (`ynt.*`, `yolo_nano_tpu_torch/utils/spans.py`) in
a traced run's `devtrace.Trace`: their intervals by name, and the device's
idle time inside them, the exact overlap of `Trace.idle_gaps()` with the
spans (not the label at a gap's middle that `breakdown` gives).

The readers of the span metrics normalise by the traced batches
(`ctx["forwards"]`) or steps (`ctx["steps"]`), and read nothing (None)
from a trace without device operations, as on the CPU, or without the
span, as at a commit whose program records none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Interval = Tuple[float, float]  # start us, end us


def named(trace, name: str) -> List[Interval]:
    """The intervals of the host spans called `name`, in order of start."""
    return sorted((s, e) for n, s, e in trace.host if n == name)


def merged(intervals: List[Interval]) -> List[Interval]:
    """The union of the intervals, as disjoint ones in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_us(a: List[Interval], b: List[Interval]) -> float:
    """Summed overlap of two lists of disjoint intervals in order."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_us(trace, intervals: List[Interval]) -> float:
    """Device idle us inside the union of `intervals`."""
    return overlap_us(trace.idle_gaps(), merged(intervals))


def units(ctx) -> Optional[int]:
    """The traced batches or steps, where the trace has device operations."""
    if not ctx["trace"].device:
        return None
    return ctx.get("forwards") or ctx.get("steps") or None


def span_ms(ctx, name: str) -> Optional[float]:
    """Summed ms of the spans `name` a batch or step."""
    n, found = units(ctx), named(ctx["trace"], name)
    if not n or not found:
        return None
    return sum(e - s for s, e in found) / 1e3 / n


def idle_ms(ctx, name: str) -> Optional[float]:
    """Device idle ms inside the spans `name` a batch or step."""
    n, found = units(ctx), named(ctx["trace"], name)
    if not n or not found:
        return None
    return idle_us(ctx["trace"], found) / 1e3 / n
