"""The readers of the program's spans (``benchmark/metrics/spans.py``):
device operations attributed to the spans in which they were launched,
only inside the traced window, and no reading where there are no spans."""

import os

import pytest
import torch

from benchmark import harness
from benchmark.metrics import spans as SP
from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import load, run_cell, tiny_root

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
NEW = {
    "train.issue_ms_p50.train": "host", "train.synthesis_device_ms.train": "device",
    "train.forward_device_ms.train": "device", "train.backward_device_ms.train": "device",
    "train.optimizer_device_ms.train": "device", "train.device_ops_per_step.train": "device",
    "lgd.fk_device_ms.train": "device", "lgd.fk_device_ms.infer": "device",
    "serve.push_ms_per_step.infer": "host", "serve.pack_ms_p50.infer": "host",
    "serve.pack_ms_p50.serve": "host", "serve.wait_ms_p50.infer": "host",
    "serve.wait_ms_p50.serve": "host", "serve.unpack_ms_p50.infer": "host",
    "serve.unpack_ms_p50.serve": "host", "serve.rows_useful_pct.serve": "host",
}


class Event:
    """A kineto event's face, as the readers see it."""

    def __init__(self, name, device, corr, start, dur=0, annotation=False):
        self._v = (name, device, corr, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def launched(corr, at, dur, name="gemm"):
    """A device operation of ``dur`` ns and its launch at ``at``."""
    return [Event("cudaLaunchKernel", CPU, corr, at), Event(name, CUDA, corr, at + 5, dur)]


class Profiler:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": lambda _: events})()})()


class Window:
    def __init__(self, t0, t1):
        self.t0, self.t1 = t0, t1


class Run:
    """A traced run's face: its tracer's device part over [t0, t1]."""

    def __init__(self, events, t0=100, t1=10_000):
        self.tracer = type("T", (), {})()
        self.tracer.trace = Window(t0, t1)
        self.tracer._windows = [(Profiler(events), t0, t1)]


SPANS = [  # (name, start, end, parent, counts)
    ("train.step", 0, 90, None, {}),                     # before the window
    ("train.step", 200, 900, None, {}),
    ("train.forward", 210, 500, "train.step", {}),
    ("lgd.fk", 300, 400, "train.forward", {}),
    ("train.loss", 510, 600, "train.step", {}),
    ("train.backward", 610, 800, "train.step", {}),
    ("train.step", 1000, 1900, None, {}),
    ("train.backward", 1100, 1800, "train.step", {}),
]


def test_an_operation_counts_for_the_spans_around_its_launch(monkeypatch):
    monkeypatch.setattr(SP, "recorded", lambda: list(SPANS))
    events = (launched(1, 350, 7000) + launched(2, 50, 100_000)      # in lgd.fk; before the window
              + launched(3, 700, 30) + launched(4, 1500, 50)         # in the two backwards
              + [Event("train.forward", CUDA, 9, 210, 290, annotation=True),
                 Event("aten::mm", CPU, 5, 220), Event("gemm", CUDA, 5, 230, 999),  # no launch
                 Event("memcpy", CUDA, 6, 950, 11)]                  # launch not recorded
              + [Event("cudaMemcpyAsync", CPU, 7, 905), Event("Memcpy HtoD", CUDA, 7, 920, 3)])
    run = Run(events)
    ph = SP.phases(run)
    assert ph["lgd.fk"] == [1, 7000, 1] and ph["train.forward"] == [1, 7000, 1]
    assert ph["train.loss"] == [1, 0, 0]
    assert ph["train.backward"] == [2, 80, 2]
    assert ph["train.step"] == [2, 7080, 3]       # the memcpy at 905 lies between steps
    assert SP.device_ms_per_step(run, ("lgd.fk",), "train.step") == 7000 / 2 / 1e6
    assert SP.device_ms_per_step(run, ("train.forward", "train.loss"), "train.step") == 3500 / 1e6
    assert SP.ops_per_step(run, "train.step") == 1.5
    assert SP.host_ms_p50(run, "train.step") == pytest.approx(800 / 1e6)   # 700 and 900 ns


def test_launches_pair_each_operation_with_its_runtime_call():
    events = (launched(1, 10, 4) + [Event("cuLaunchKernel", CPU, 2, 20),
                                    Event("sm90_gemm", CUDA, 2, 25, 6),
                                    Event("serve.step", CUDA, 3, 5, 50, annotation=True),
                                    Event("aten::add", CPU, 4, 30), Event("add", CUDA, 4, 31, 1)])
    assert SP.launches(events, CUDA) == [(10, 4), (20, 6)]


def test_host_readings_between_steps_and_counts(monkeypatch):
    spans = [("serve.step", 200, 300, None, {"rows_run": 8, "rows_ready": 2}),
             ("serve.pack", 210, 250, "serve.step", {}),
             ("serve.step", 400, 500, None, {"rows_run": 8, "rows_ready": 6}),
             ("serve.step", 530, 700, None, {"rows_run": 8, "rows_ready": 4}),
             ("serve.step", 900, 2000, None, {"rows_run": 8, "rows_ready": 4})]
    monkeypatch.setattr(SP, "recorded", lambda: spans)
    run = Run([])
    assert SP.gap_ms_p50(run, "serve.step") == 100 / 1e6   # median of 100, 30, 200
    assert SP.gap_ms_p50(run, "serve.pack") is None        # one span: no gap
    assert SP.count_share(run, "serve.step", "rows_ready", "rows_run") == 50.0
    assert SP.phases(run) is None and SP.device_ms_per_step(run, ("x",), "serve.step") is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_reads_none_without_spans(monkeypatch, name):
    mod = harness.reader(ROOT, name)
    monkeypatch.setattr(SP, "recorded", lambda: None)   # a program that records no spans
    assert mod.read(Run(launched(1, 350, 7000))) is None
    monkeypatch.setattr(SP, "recorded", lambda: list(SPANS))
    assert mod.read(type("R", (), {"tracer": None})()) is None   # a run without a trace


def test_new_entries_have_files_and_cells():
    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {m["name"]: m for m in spec["per_layer"]}
    cells = {w["name"] for w in spec["workloads"]}
    for name in NEW:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", name + ".py"))
        assert entries[name]["workloads"] and set(entries[name]["workloads"]) <= cells, name


def test_a_traced_cpu_run_reads_the_host_spans_only(tmp_path):
    """On the CPU the serving spans' host times read numbers (the push's
    needs two steps in the traced part, which a slow host may not make); no
    device time is read, since the CPU's trace holds no device operation."""
    res = run_cell(tiny_root(tmp_path), "lgd_rnn6.infer.s64c256", trace=True)
    want = {"serve.pack_ms_p50.infer", "serve.wait_ms_p50.infer", "serve.unpack_ms_p50.infer"}
    assert want <= set(res["metrics"])
    assert "lgd.fk_device_ms.infer" not in res["metrics"]
    for name in want:
        assert res["metrics"][name]["value"] > 0, name
