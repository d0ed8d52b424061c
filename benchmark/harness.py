"""One run of one cell: find its files by name, hand them to the driver of
its traffic, read the metrics, decide ``correct`` and print the result.

Every piece is found by a name in ``BENCHMARK.json``, so a later cell,
configuration, traffic mix or per-layer metric is a new file and a new
entry, never an edit:

- configuration ``<name>``: the ``file`` its entry names (flags of
  ``empose_tpu_torch.config.Configuration``, source, what was assumed);
- traffic mix ``<name>``: ``benchmark/traffic/<name>.json``, parameters
  read by the driver that its ``driver`` key names,
  ``benchmark/drivers/<driver>.py`` (``setup(run)``, ``window(run, state)``,
  ``check(run, state)``; ``control(run, state)`` for ``calibrate.py``);
- per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, whose
  ``read(run)`` returns a number or None (nothing to read);
- the limits of the cell's compared numbers: ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "empose_tpu")


class Run:
    """What one run knows and gathers; drivers fill it, readers read it."""

    def __init__(self, root: str, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: Optional[float] = None):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cell = entry(self.spec["workloads"], cell, "cell")
        config = entry(self.spec["configs"], self.cell["config"], "configuration")
        self.config = load_json(os.path.join(root, config["file"]))
        self.flags: Dict = dict(self.config["flags"])
        self.traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                              self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(root, "benchmark", "limits", cell + ".json"))
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), trace, device
        self.started = time.perf_counter() if started is None else started
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.numbers: List[Tuple[str, float, float]] = []   # compared: (name, value, limit)
        self.attempted = 0
        self.failed = 0
        self.spans: Dict[str, List[Tuple[int, int]]] = {}   # timed host spans, time.time_ns
        self.marks: Dict[str, List[Tuple[int, int]]] = {}   # every host span, for the trace
        self.counters: Dict[str, float] = {}
        self.shapes: Dict[str, Dict] = {}                    # kernel shapes for rooflines
        self.flops_per_call: Optional[float] = None          # reference count of one call
        self.tracer = None
        self.memory_peak = 0
        self.phases: List[Tuple[str, float]] = []

    def span(self, name: str, start_ns: int, end_ns: int, timed: bool = True) -> None:
        """A host span of the benchmark's around a call; ``timed`` ones feed
        the per-layer times (a call slowed by the host trace is not)."""
        self.marks.setdefault(name, []).append((start_ns, end_ns))
        if timed:
            self.spans.setdefault(name, []).append((start_ns, end_ns))

    def set_up_done(self) -> None:
        self.setup_s = time.perf_counter() - self.started

    def compare(self, name: str, value: float) -> None:
        """Record a number beside its limit from the cell's limits file; a
        number the file gives no limit is read but not compared."""
        if name in self.limits:
            self.numbers.append((name, float(value), float(self.limits[name])))

    @property
    def trace_data(self):
        return None if self.tracer is None else self.tracer.trace

    @property
    def calls_traced(self) -> int:
        return 0 if self.tracer is None else self.tracer.calls

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed with the result)."""
        self.phases.append((name, time.perf_counter()))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def entry(items: List[Dict], name: str, what: str) -> Dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(run: Run):
    return importlib.import_module(f"benchmark.drivers.{run.traffic['driver']}")


def reader(root: str, metric: str):
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    return load_file_module(path, "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def execute(run: Run) -> Dict:
    """Set up, measure and check one cell; returns the result's object."""
    from benchmark.drivers import common
    mod = driver(run)
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        run.tmp = tmp
        state = mod.setup(run)
        run.set_up_done()
        marks = [("start", run.started)] + run.phases
        print("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
              + f"; total {run.setup_s:.3f} s", file=sys.stderr, flush=True)
        mod.window(run, state)
        run.memory_peak = common.memory_peak(run)
        run.e2e["peak_mem_gib"] = run.memory_peak / 2 ** 30
        mod.check(run, state)
    metrics = {}
    if not run.trace:
        for m in run.spec["end_to_end"]:
            if applies(m, run.cell["name"]):
                value = run.setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.spec["per_layer"]:
            if applies(m, run.cell["name"]):
                value = reader(run.root, m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = run.failed == 0 and bool(run.numbers) and all(v <= lim for _, v, lim in run.numbers)
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": common.device_info(run)}
    tr = run.trace_data
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        host = run.tracer.host_trace or tr
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": host.idle_gaps(run.marks)}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in run.numbers}
    return result
