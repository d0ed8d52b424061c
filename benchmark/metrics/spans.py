"""The program's own spans (``empose_tpu_torch.utils.profiling.span``) in a
traced run, read by the per-layer metrics of its phases.

A span is ``(name, start_ns, end_ns, parent, counts)`` on the clock of the
profiler's events (``time.time_ns``). Readers take the spans inside the
device part of the traced window (``run.trace_data.t0`` to ``t1``), whose
calls the benchmark synchronizes one by one.

Device time of a phase: each device operation belongs to the spans in which
its launch happened, the innermost one and those around it. Its launch is
the host's CUDA API call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cuLaunchKernel``...) that carries the operation's
correlation id, which the device part's profiler records without the host's
operators (read from the profiler that ``benchmark/trace.Tracer`` keeps).

Every reading is None where there is nothing to read: a program that
records no spans, a run without a trace, or a trace with no device
operation (the CPU) for the device times.
"""

from __future__ import annotations

import bisect
from statistics import median
from typing import Dict, List, Optional, Tuple

from benchmark.trace import _annotation

Span = Tuple[str, int, int, Optional[str], Dict[str, float]]


def recorded() -> Optional[List[Span]]:
    """Every span the program holds, or None where it records none."""
    try:
        from empose_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def spans_in(run) -> Optional[List[Span]]:
    """The program's spans inside the device part of the traced window, by
    start time."""
    tr = None if run.tracer is None else run.tracer.trace
    all_spans = recorded()
    if tr is None or all_spans is None:
        return None
    return sorted((s for s in all_spans if tr.t0 <= s[1] and s[2] <= tr.t1), key=lambda s: s[1])


def launches(events, cuda) -> List[Tuple[int, int]]:
    """``(launch ns, device ns)`` of each device operation among a
    profiler's kineto ``events`` (``cuda``: the device type of device
    events) whose launch is among them too, by launch time."""
    launched: Dict[int, int] = {}
    device: List[Tuple[int, int]] = []
    for e in events:
        if e.device_type() == cuda:
            if not _annotation(e):
                device.append((e.correlation_id(), e.duration_ns()))
        elif e.name().startswith("cu") and not _annotation(e):
            launched.setdefault(e.correlation_id(), e.start_ns())
    return sorted((launched[c], ns) for c, ns in device if c in launched)


def attribute(spans: List[Span], ops: List[Tuple[int, int]]) -> Dict[str, List[float]]:
    """Per span name: ``[spans, device ns, device operations]``, each
    operation counted for every span whose interval holds its launch."""
    at = [t for t, _ in ops]
    ns_sum = [0]
    for _, ns in ops:
        ns_sum.append(ns_sum[-1] + ns)
    out: Dict[str, List[float]] = {}
    for name, a, b, _, _ in spans:
        i, j = bisect.bisect_left(at, a), bisect.bisect_right(at, b)
        row = out.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += ns_sum[j] - ns_sum[i]
        row[2] += j - i
    return out


def phases(run) -> Optional[Dict[str, List[float]]]:
    """:func:`attribute` over the device part; None where it holds no span
    or no launched operation. Read once a run."""
    if "_span_phases" not in run.__dict__:
        import torch
        windows = getattr(run.tracer, "_windows", [])
        spans = spans_in(run)
        ops = spans and windows and launches(windows[0][0].profiler.kineto_results.events(),
                                             torch.autograd.DeviceType.CUDA)
        run._span_phases = attribute(spans, ops) if spans and ops else None
    return run._span_phases


def device_ms_per_step(run, names, step: str) -> Optional[float]:
    """Device ms of the operations launched in spans named ``names``, per
    ``step`` span."""
    ph = phases(run)
    if not ph or not ph.get(step, [0])[0]:
        return None
    return sum(ph[n][1] for n in names if n in ph) / ph[step][0] / 1e6


def ops_per_step(run, step: str) -> Optional[float]:
    """Device operations launched in each ``step`` span, on average."""
    ph = phases(run)
    if not ph or not ph.get(step, [0])[0]:
        return None
    return ph[step][2] / ph[step][0]


def host_ms_p50(run, name: str) -> Optional[float]:
    """Median host time of the spans named ``name``, ms."""
    spans = [s for s in spans_in(run) or () if s[0] == name]
    return median((b - a) / 1e6 for _, a, b, _, _ in spans) if spans else None


def gap_ms_p50(run, step: str) -> Optional[float]:
    """Median host ms from the end of one ``step`` span to the start of the
    next: what the caller does between two steps."""
    steps = [s for s in spans_in(run) or () if s[0] == step]
    if len(steps) < 2:
        return None
    return median((after[1] - before[2]) / 1e6 for before, after in zip(steps, steps[1:]))


def count_share(run, name: str, part: str, whole: str) -> Optional[float]:
    """Sum of the ``part`` count over the sum of the ``whole`` count of the
    ``name`` spans, %."""
    spans = [s for s in spans_in(run) or () if s[0] == name]
    total = sum(s[4].get(whole, 0) for s in spans)
    return 100.0 * sum(s[4].get(part, 0) for s in spans) / total if total else None
