"""The traced window: ``torch.profiler`` over whole calls of the timed
path, read once it closes into device intervals (kernels, copies, sets)
and host operations on one clock, the epoch in nanoseconds that
``time.time_ns`` also reads.

``busy_s`` is the union of the device intervals inside the window, so
overlapping streams count once; an idle gap is a stretch of the window
with no device interval, named by the benchmark's own host span and the
innermost host operation running at its middle ("python" where none runs:
the interpreter between operations).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


class Trace:
    """Device and host events of one traced window."""

    def __init__(self, device_events, host_events, t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        self.device = sorted(device_events, key=lambda e: e[1])   # (name, start, end) ns
        self.host = sorted(host_events, key=lambda e: e[1])
        self._merged = self._union()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _union(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged) / 1e9

    def kernels(self, part: str) -> Tuple[int, float]:
        """Launches and device seconds of the operations whose name holds ``part``."""
        hits = [b - a for name, a, b in self.device if part in name]
        return len(hits), sum(hits) / 1e9

    def top_ops(self, n: int = TOP) -> List[List]:
        by_name: Dict[str, int] = defaultdict(int)
        for name, a, b in self.device:
            by_name[name] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t / 1e9] for name, t in top]

    def gaps(self) -> List[Tuple[int, int]]:
        edges = [self.t0] + [x for ab in self._merged for x in ab] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_gaps(self, spans: Dict[str, List[Tuple[int, int]]], n: int = TOP) -> List[List]:
        """Idle seconds summed by what the host was doing, the ``n`` largest."""
        span_list = sorted((a, b, name) for name, ivs in spans.items() for a, b in ivs)
        span_starts = [s[0] for s in span_list]
        host_starts = [e[1] for e in self.host]
        total: Dict[str, int] = defaultdict(int)
        for a, b in self.gaps():
            mid = (a + b) // 2
            total[f"{_covering(span_list, span_starts, mid, 0, 2, 'between calls')} | "
                  f"{_covering(self.host, host_starts, mid, 1, 0, 'python')}"] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t / 1e9] for name, t in top]


def _covering(events, starts, t: int, at: int, name_at: int, none: str, walk: int = 4000) -> str:
    """The latest-starting event that covers ``t`` (the innermost, where
    events nest), or ``none``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - walk, -1), -1):
        if events[j][at + 1] >= t:
            return str(events[j][name_at])
    return none


class Tracer:
    """``torch.profiler`` over whole calls of a measured window, in two
    parts: ``trace_seconds`` of device activity alone (the device metrics:
    busy and idle time, kernel times), then one call with the host's
    operations too (what the host does in the idle gaps; recording every
    host operation slows the host, so those calls are not the device
    metrics'). Does nothing when tracing is off."""

    def __init__(self, enabled: bool, seconds: float = 0.0):
        self.enabled, self.seconds = enabled, seconds
        self.part = 0 if enabled else 2      # 0: device part, 1: host part, 2: done
        self.calls = 0                       # calls in the device part
        self._windows: list = []
        self._read_windows: list = []
        self._prof = None

    def warm(self) -> None:
        """Profile one empty moment, so the profiler's own start-up falls in set-up."""
        if self.enabled:
            self._start(host=True)
            self._stop()
            self._windows.clear()

    def begin(self) -> None:
        """At the start of the measured window."""
        if self.part == 0:
            self._start(host=False)

    def after_call(self, elapsed: float, calls: int) -> None:
        """After each whole call, ``elapsed`` seconds and ``calls`` calls
        into the measured window."""
        if self.part == 0 and elapsed >= self.seconds:
            self._stop()
            self.calls = calls
            self._start(host=True)
            self.part = 1
        elif self.part == 1:
            self._stop()
            self.part = 2

    def end(self, calls: int) -> None:
        """At the close of the measured window."""
        if self.part == 0:
            self.calls = calls
        if self.part < 2:
            self._stop()
            self.part = 2

    def _start(self, host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.time_ns()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.stop()
        self._windows.append((self._prof, self._t0, t1))
        self._prof = None

    def _part(self, k: int) -> Optional[Trace]:
        while len(self._read_windows) < len(self._windows):
            self._read_windows.append(self._read(*self._windows[len(self._read_windows)]))
        return self._read_windows[k] if k < len(self._read_windows) else None

    @property
    def trace(self) -> Optional[Trace]:
        """The device part, read at first use (after the measured window)."""
        return self._part(0)

    @property
    def host_trace(self) -> Optional[Trace]:
        """The part with the host's operations."""
        return self._part(1)

    @staticmethod
    def _read(prof, t0: int, t1: int) -> Trace:
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not _annotation(e):
                    device.append(item)
            else:
                host.append(item)
        return Trace(device, host, t0, t1)


def _annotation(e) -> bool:
    """A range the profiler marks on the device timeline (an optimizer's
    step), not an operation."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else "#" in e.name()
