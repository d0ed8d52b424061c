"""The program's spans (``utils/profiling.span``): recorded only while a
``torch.profiler`` runs, on the clock of the profiler's events, at the
trainer's phases, the LGD loop's FK, gradient and MLP blocks and the
multi-stream server's pack, upload, forward, download and unpack, and with
no change to any loss, weight or served pose.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from empose_tpu_torch import constants as C
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.serve import MultiStreamPredictor
from empose_tpu_torch.train.loop import Trainer
from empose_tpu_torch.utils import profiling
from tests.test_torch_train_loop import TINY_LGD

torch.set_num_threads(1)
N_ITER = 2   # TINY_LGD's refinement steps
TRAIN_PHASES = ["train.upload", "train.synthesis", "train.forward", "train.loss",
                "train.backward", "train.optimizer"]
SERVE_PHASES = ["serve.pack", "serve.upload", "serve.forward", "serve.download", "serve.unpack"]
S, CHUNK = 4, 4


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the spans, the profiler)."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


def _trainer(remat: bool = False) -> Trainer:
    flags = TINY_LGD[:-2] + (["--remat"] if remat else [])
    return Trainer(Configuration(vars(Configuration.parser().parse_args(flags))), device="cpu")


def _host_batches(n: int):
    loader = EMRBatchLoader(os.path.join(C.data_dir_synth(), "amass_emr"), 2, 16, shuffle=True,
                            seed=3, window_rng=np.random.RandomState(4313))
    batches = []
    while len(batches) < n:
        batches += list(loader)
    return batches[:n]


def _children(spans, parent):
    return [s for s in spans if s[3] == parent]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] <= child[2] <= parent[2]


def test_span_records_nothing_without_a_profiler():
    profiling.clear_spans()
    with profiling.span("outer") as sp:
        with profiling.span("inner") as inner:
            torch.ones(3).sum()
        assert not sp.recording and not inner.recording
    assert profiling.spans() == []
    assert not hasattr(sp, "counts")   # nothing built for counts


def test_nested_span_shares_the_profilers_clock():
    """Name, times, parent and counts of nested spans; the profiler's own
    event of each span lies within 2 ms of the recorded times."""
    def body():
        with profiling.span("outer") as sp:
            with profiling.span("inner"):
                torch.ones(64).sum()
            assert sp.recording
            sp.count(rows=2)
            sp.count(ready=5)

    _, spans, prof = _profiled(body)
    assert [(s[0], s[3], s[4]) for s in spans] == [("inner", "outer", {}),
                                                  ("outer", None, {"rows": 2, "ready": 5})]
    inner, outer = spans
    assert outer[1] <= inner[1] < inner[2] <= outer[2]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")}
    assert sorted(events) == ["inner", "outer"]
    for name, start, end, _, _ in spans:
        assert abs(events[name].start_ns() - start) < 2e6, name
        assert abs(events[name].end_ns() - end) < 2e6, name
    profiling.clear_spans()
    assert profiling.spans() == []


@pytest.mark.parametrize("remat", [False, True])
def test_lgd_train_step_span_tree(assets_env, remat):
    """``train.step`` holds the six phases in order; the LGD forward's N+1
    FK blocks, N gradients and N MLP steps lie in ``train.forward``."""
    trainer = _trainer(remat)
    (host,) = _host_batches(1)
    _, spans, _ = _profiled(lambda: trainer.train_step(host))
    (step,) = [s for s in spans if s[0] == "train.step"]
    assert step[3] is None
    phases = sorted(_children(spans, "train.step"), key=lambda s: s[1])
    assert [s[0] for s in phases] == TRAIN_PHASES
    assert all(_inside(s, step) for s in phases)
    (forward,) = [s for s in phases if s[0] == "train.forward"]
    lgd = sorted(_children(spans, "train.forward"), key=lambda s: s[1])
    assert [s[0] for s in lgd] == (["lgd.init", "lgd.fk"]
                                   + ["lgd.grad", "lgd.mlp", "lgd.fk"] * N_ITER)
    assert all(_inside(s, forward) for s in lgd)
    assert {s[0] for s in spans} == {"train.step", *TRAIN_PHASES, "lgd.init", "lgd.fk",
                                     "lgd.grad", "lgd.mlp"}


def test_multistream_step_span_tree(assets_env):
    """A step with two of four streams ready: ``serve.step`` holds the five
    phases in order and counts the rows run and the ready rows; ``push``
    records nothing; the eval forward's FK blocks lie in ``serve.forward``."""
    model = _trainer().model.eval()
    pred = MultiStreamPredictor(model, S, CHUNK)
    rng = np.random.RandomState(0)

    def feed(i, k):
        pred.push(i, (rng.randn(k, 36) * 0.3).astype(np.float32),
                  (rng.randn(k, 108) * 0.3).astype(np.float32))

    for i in range(S):
        feed(i, CHUNK)
    pred.step()   # offsets uploaded once, before the profiled step

    def body():
        feed(0, CHUNK)
        feed(2, CHUNK)
        feed(3, CHUNK // 2)
        return pred.step()

    outs, spans, _ = _profiled(body)
    assert sorted(outs) == [0, 2]
    assert [s[0] for s in spans if s[3] is None] == ["serve.step"]
    (step,) = [s for s in spans if s[0] == "serve.step"]
    assert step[4] == {"rows_run": S, "rows_ready": 2}
    phases = sorted(_children(spans, "serve.step"), key=lambda s: s[1])
    assert [s[0] for s in phases] == SERVE_PHASES
    assert all(_inside(s, step) for s in phases)
    fk = [s for s in spans if s[0] == "lgd.fk"]
    assert len(fk) == N_ITER + 1 and {s[3] for s in fk} == {"serve.forward"}
    assert len([s for s in spans if s[0] == "lgd.grad"]) == N_ITER


def test_spans_change_no_result(assets_env):
    """Two training steps, and a served step of every stream, with and
    without a profiler running: losses, weights and poses equal bit for bit."""
    batches = _host_batches(2)

    def train():
        trainer = _trainer()
        losses = [trainer.train_step(b) for b in batches]
        return trainer, losses

    (plain, plain_losses), (traced, traced_losses) = train(), _profiled(train)[0]
    for a, b in zip(plain_losses, traced_losses):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    for k, v in plain.model.state_dict().items():
        assert torch.equal(traced.model.state_dict()[k], v), k

    model = plain.model.eval()
    rng = np.random.RandomState(1)
    feeds = [((rng.randn(2 * CHUNK, 36) * 0.3).astype(np.float32),
              (rng.randn(2 * CHUNK, 108) * 0.3).astype(np.float32)) for _ in range(S)]

    def serve():
        pred = MultiStreamPredictor(model, S, CHUNK)
        for i, (pos, ori) in enumerate(feeds):
            pred.push(i, pos, ori)
        return [pred.step(), pred.step()]

    want, (got, spans, _) = serve(), _profiled(serve)
    assert len([s for s in spans if s[0] == "serve.step"]) == 2
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g) == list(range(S))
        for i in w:
            for k in w[i]:
                assert np.array_equal(w[i][k], g[i][k]), (i, k)
