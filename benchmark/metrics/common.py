"""Readings shared by the per-layer metrics' readers: each returns None
where the run has nothing to read."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from benchmark.metrics.roofline import FP32_PEAK


def step_ms_p50(run, span: str) -> Optional[float]:
    """Median of the benchmark's host span around each call, in ms."""
    spans = run.spans.get(span)
    if not spans:
        return None
    return float(np.median([(b - a) / 1e6 for a, b in spans]))


def device_idle(run) -> Optional[float]:
    """Share of the traced window with no operation on the device, %."""
    tr = run.trace_data
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(run) -> Optional[float]:
    """The reference's FLOPs of the traced calls over the traced window, as
    a share of the fp32 peak, %."""
    tr = run.trace_data
    if tr is None or not run.flops_per_call or not run.calls_traced:
        return None
    return 100.0 * run.flops_per_call * run.calls_traced / tr.window_s / FP32_PEAK


def roofline(run, shape_key: str, parts: Sequence[str],
             least: Sequence[Callable[[dict], float]]) -> Optional[float]:
    """Least time of every launch of the kernels named by ``parts`` (each
    launch at the run's shapes under ``shape_key``) over their traced
    device time, %."""
    tr, shape = run.trace_data, run.shapes.get(shape_key)
    if tr is None or shape is None:
        return None
    bound = spent = 0.0
    for part, fn in zip(parts, least):
        launches, seconds = tr.kernels(part)
        bound += launches * fn(shape)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
