"""Profiling helpers: ``torch.profiler`` traces and step timing (port of
``empose_tpu/utils/profiling.py``).

``trace(log_dir)`` records the host's operators, and the card's kernels
where CUDA is present, and writes one Chrome trace (JSON) into ``log_dir``
when the block ends (``--profile_dir`` of the trainer). The timers
synchronize the devices of the tensors they are given, so a time covers the
device work that was queued for them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the devices of the CUDA tensors in ``tree`` (a tensor, or
    dicts, lists and tuples of them)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def chain_calls(iters: int, warmup: int, repeats: int = 1) -> int:
    """Calls of the step function that :func:`timeit_chain` makes."""
    return 1 + warmup + repeats * iters


def timeit_chain(step_fn, carry, iters: int = 20, warmup: int = 3, repeats: int = 3) -> float:
    """Best-of-``repeats`` mean wall-clock ms per call of ``carry =
    step_fn(carry)``: one untimed call, ``warmup`` warm calls, then
    ``repeats`` blocks of ``iters`` timed calls, each block closed by
    synchronizing the devices of ``carry``."""
    carry = step_fn(carry)
    block_until_ready(carry)
    for _ in range(warmup):
        carry = step_fn(carry)
    block_until_ready(carry)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            carry = step_fn(carry)
        block_until_ready(carry)
        best = min(best, time.perf_counter() - t0)
    return best / iters * 1e3


def timeit_ms(fn, *args, iters: int = 20, warmup: int = 3, repeats: int = 1) -> float:
    """:func:`timeit_chain` of ``fn(*args)``, each call's output the carry
    (read only to synchronize its devices)."""
    return timeit_chain(lambda _: fn(*args), None, iters, warmup, repeats)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block into a Chrome trace ``trace.<pid>.<ms>.json`` in
    ``log_dir`` (made if absent), written when the block ends, also by an
    exception; no ``log_dir``: nothing. Yields the profiler or None."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's timeline."""
    with record_function(name):
        yield


class Timings:
    """Exponential moving averages of phase times, by name."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ema: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, name: str, block_on=None):
        """Time the block; with ``block_on`` (tensors) after their devices
        are done."""
        start = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        dt = time.perf_counter() - start
        self.ema[name] = dt if name not in self.ema else (
            self.decay * self.ema[name] + (1 - self.decay) * dt)

    def summary(self) -> str:
        return " ".join(f"{k}: {v * 1000:.2f}ms" for k, v in self.ema.items())
