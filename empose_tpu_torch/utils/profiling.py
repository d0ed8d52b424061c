"""Profiling helpers: ``torch.profiler`` traces, the program's spans and
step timing (port of ``empose_tpu/utils/profiling.py``).

``trace(log_dir)`` records the host's operators, and the card's kernels
where CUDA is present, and writes one Chrome trace (JSON) into ``log_dir``
when the block ends (``--profile_dir`` of the trainer). The timers
synchronize the devices of the tensors they are given, so a time covers the
device work that was queued for them.

``span(name)`` marks a phase of the program (``train.*``, ``lgd.*``,
``serve.*``). While a ``torch.profiler`` runs it opens a
``record_function`` range of that name, so the phase shows in the trace,
and appends ``(name, start_ns, end_ns, parent, counts)`` to a bounded
buffer (:func:`spans`), both times from ``time.time_ns``, the clock of the
profiler's events; ``parent`` is the name of the span open around it in the
same thread (None at the top), ``counts`` what :meth:`span.count` gave it.
With no profiler running a span costs one flag check.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_BUFFER = 1 << 18   # spans kept; the oldest go first

SpanRecord = Tuple[str, int, int, Optional[str], Dict[str, float]]
_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_open = threading.local()   # per thread: names of the spans open, innermost last


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


class span:
    """A phase of the program, recorded while a profiler runs.

    ``with span("serve.step") as s: ... if s.recording: s.count(rows_run=n)``:
    counts are the span's attributes (numbers of what it did), kept with it;
    compute them only while :attr:`recording`, so that a span costs one flag
    check when no profiler runs. A plain class, not a generator: it sits on
    per-step paths.
    """

    __slots__ = ("name", "counts", "_range", "_start", "_parent")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    @property
    def recording(self) -> bool:
        """Whether the span is being recorded (a profiler ran at its enter)."""
        return self._range is not None

    def count(self, **counts) -> None:
        """Add ``counts`` to a span being recorded; call it only while
        :attr:`recording`."""
        self.counts.update(counts)

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            stack = getattr(_open, "names", None)
            if stack is None:
                stack = _open.names = []
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
            self.counts = {}
            self._start = time.time_ns()
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            _spans.append((self.name, self._start, time.time_ns(), self._parent, self.counts))
            _open.names.pop()
            self._range = None


def spans() -> List[SpanRecord]:
    """The recorded spans in the order they ended: ``(name, start_ns,
    end_ns, parent, counts)``."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()
