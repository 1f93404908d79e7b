"""Reading a `torch.profiler` trace of a traced run.

The run's traced window is the harness's own span `bench.window`; inside
it the trace gives every device operation (kernels, copies, memsets) and
every host operation the profiler records. The trace is exported as
Chrome-trace JSON to a temporary file, read once and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"

Event = Tuple[str, float, float]  # name, start us, end us


@dataclass
class Trace:
    """Device and host operations inside the traced window (us)."""

    start: float
    end: float
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    _starts: Optional[List[float]] = None
    _reach: Optional[List[float]] = None  # the latest end up to each event

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def device_s(self, *parts: str) -> float:
        """Summed device seconds of the operations whose name holds any of
        `parts` (all of them without parts)."""
        return sum(e - s for n, s, e in self.device
                   if not parts or any(p in n for p in parts)) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, merged."""
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda ev: ev[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals inside the window."""
        gaps, at = [], self.start
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    def host_label(self, t: float) -> str:
        """The innermost host operation running at t (the latest to start
        among those that span it), or "host idle"."""
        if self._starts is None:
            self.host.sort(key=lambda ev: ev[1])
            self._starts = [s for _, s, _ in self.host]
            self._reach, reach = [], float("-inf")
            for _, _, e in self.host:
                reach = max(reach, e)
                self._reach.append(reach)
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            if self._reach[i] < t:  # nothing this early is still running
                break
            n, s, e = self.host[i]
            if e >= t:
                return n
        return "host idle"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing in the middle of each gap: [name, s]."""
        ops: dict = {}
        for n, s, e in self.device:
            key = _short(n)
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
        gaps: dict = {}
        for s, e in self.idle_gaps():
            key = _short(self.host_label((s + e) / 2))
            gaps[key] = gaps.get(key, 0.0) + (e - s) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def _short(name: str) -> str:
    """A kernel's signature without its arguments, namespaces kept."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:96]


class Window:
    """`torch.profiler` (host, and the device's activity on CUDA) over a
    window that `start` opens and `stop` closes, marked by the span
    `WINDOW`; `read` then gives its `Trace`."""

    def __init__(self, dev):
        self.dev, self.prof, self.span = dev, None, None

    def start(self) -> None:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = record_function(WINDOW)
        self.span.__enter__()

    @property
    def open(self) -> bool:
        return self.span is not None

    def stop(self) -> None:
        if self.open:
            self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.span = None

    def read(self) -> "Trace":
        return read(self.prof)


def read(prof) -> Trace:
    """The traced window of a finished `torch.profiler.profile`."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w = windows[0]
    trace = Trace(float(w["ts"]), float(w["ts"]) + float(w["dur"]))
    for e in spans:
        s = float(e["ts"])
        end = s + float(e["dur"])
        if end < trace.start or s > trace.end:
            continue
        ev = (e.get("name", ""), max(s, trace.start), min(end, trace.end))
        if e.get("cat") in DEVICE_CATS:
            trace.device.append(ev)
        elif e.get("cat") in HOST_CATS and e is not w:
            trace.host.append(ev)
    return trace
