"""``--steps_per_call``: the port's chunks of K training steps
(``Trainer.train_step_chunk`` and ``fit``) against single steps and against
the JAX ``fit``'s chunk boundaries.

A chunk runs its K steps one after another, so every comparison with
single steps is bit for bit (``torch.equal``). The chunk sizes are held
against the JAX ``fit`` (``empose_tpu/train/loop.py``) driven with a stub
trainer that records the batches it is handed per call; both packages'
``MetricsEngine`` is replaced by a stub in the test, nothing of the JAX
package is edited.
"""

import json
import os

import numpy as np
import pytest
import torch

import empose_tpu.train.loop as JL

import empose_tpu_torch.train.loop as TL
from empose_tpu_torch.tools.multihost_worker import tiny_batch, tiny_config
from empose_tpu_torch.train.cli import main
from empose_tpu_torch.train.loop import Trainer
from tests.test_torch_train_loop import TINY_LGD

torch.set_num_threads(1)


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_chunk_equals_single_steps(assets_env):
    """K = 4 steps in one ``train_step_chunk`` equal 4 ``train_step`` calls
    bit for bit (losses with a leading K axis, weights, BatchNorm
    statistics, Adam's state and the generator), with offset noise,
    spherical noise and dropout drawing from the generator."""
    config = tiny_config(m_dropout=0.2, m_dropout_hidden=0.2, spherical_noise_strength=0.5,
                         spherical_noise_length=0.5)
    rng = np.random.RandomState(7)
    batches = [tiny_batch(rng, n=3, f=8) for _ in range(4)]
    batches[2]["seq_lengths"][1] = 3
    single, chunked = (Trainer(config, seed=5, device="cpu") for _ in range(2))
    vals = [single.train_step(b) for b in batches]
    got = chunked.train_step_chunk(batches)
    assert chunked.global_step == single.global_step == 4
    assert sorted(got) == sorted(vals[0])
    for k, v in got.items():
        assert v.shape == (4,)
        assert torch.equal(v, torch.stack([s[k] for s in vals])), k
    want = _state(single)
    for k, v in _state(chunked).items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(chunked.generator.get_state(), single.generator.get_state())
    for (a, b) in zip(single.opt.state.values(), chunked.opt.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    one = chunked.train_step_chunk(batches[:1])  # K = 1: scalars, as the JAX chunk
    assert all(v.dim() == 0 for v in one.values())


def _losses(model_dir):
    with open(os.path.join(model_dir, "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "train/total_loss"}


# One window per batch (bs 1, 3 sequences): every batch has the same shape,
# so a chunk can cross an epoch's end; print and eval beyond the run.
SPC = TINY_LGD + ["--bs_train", "1", "--print_every", "100"]


def test_fit_steps_per_call_equals_one(assets_env, tmp_path, monkeypatch):
    """The train CLI at ``--steps_per_call 4`` and 1 over 9 steps, with
    chunks crossing epochs: every logged loss, and the checkpoint (weights,
    Adam, generator, step), bit for bit; a run stopped at step 5, mid-chunk
    of the uninterrupted run, and resumed to 9 at K = 4: its losses and
    final trainer (weights, Adam, generator) bit for bit too."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    runs = {}
    for eid, k, steps, resume in (("700101", "1", 9, False), ("700102", "4", 9, False),
                                  ("700103", "4", 5, False), ("700103", "4", 9, True)):
        runs[eid] = main(SPC + ["--experiment_id", eid, "--steps_per_call", k,
                                "--max_steps", str(steps)] + (["--resume"] if resume else []))
    want = _losses(runs["700101"][0])
    assert sorted(want) == list(range(1, 10))
    saved = [torch.load(os.path.join(runs[eid][0], "checkpoint", "train_state.pt"),
                        weights_only=True) for eid in ("700101", "700102")]
    # The run that wrote the checkpoint of 700103 ended at step 5; its
    # resumed run's state is that of the trainer it returns.
    states = saved + [runs["700103"][1].train_state_dict()]
    assert [s["global_step"] for s in states] == [9, 9, 9]
    for eid in ("700102", "700103"):
        assert _losses(runs[eid][0]) == want, eid
    a = states[0]
    for b in states[1:]:
        for k, v in a["model"].items():
            assert torch.equal(b["model"][k], v), k
        assert torch.equal(a["generator"], b["generator"])
        for i, s in a["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(b["optimizer"]["state"][i][k], v), k


class _StubEngine:
    def __init__(self, *args):
        pass

    def get_metrics(self):
        return {}

    @staticmethod
    def to_pretty_string(metrics, name):
        return ""

    @staticmethod
    def to_log_dict(metrics, name):
        return {}


class _StubTrainer:
    """Records the number of batches of each ``train_step_chunk`` call."""

    def __init__(self, config):
        self.config, self.smplh, self.device, self.rank = config, None, "cpu", 0
        self.global_step, self.epoch, self.best_test_loss = 0, 0, float("inf")
        self.chunks = []

    def train_step_chunk(self, batches):
        k = len(batches)
        self.chunks.append(k)
        self.global_step += k
        return {"total_loss": torch.zeros(()) if k == 1 else torch.zeros(k)}

    def evaluate_valid(self, loader, me):
        return {"total_loss": 1.0}

    def evaluate_test(self, loader, me, window):
        return {"total_loss": 1.0}

    def save(self, path):
        pass

    def barrier(self):
        pass


GRID = [
    # (batches per epoch, short final batch, print_every, eval_every, max_steps, K, epochs)
    (5, False, 100, 10 ** 6, None, 8, 3),
    (5, True, 100, 10 ** 6, None, 8, 3),
    (7, False, 3, 10 ** 6, None, 4, 2),
    (7, True, 4, 6, None, 3, 2),
    (6, False, 100, 5, 14, 4, 4),
    (6, True, 2, 4, 11, 8, 3),
    (9, False, 5, 7, 20, 8, 3),
    (4, True, 100, 10 ** 6, 6, 8, 5),
    (3, False, 1, 2, None, 8, 2),
    (8, False, 100, 10 ** 6, 17, 1, 3),
    (10, True, 6, 9, 25, 5, 3),
    (2, True, 3, 10 ** 6, 5, 16, 4),
]


@pytest.mark.parametrize("n_batches, short, print_every, eval_every, max_steps, k, epochs", GRID)
def test_fit_cuts_chunks_as_jax(tmp_path, monkeypatch, n_batches, short, print_every,
                                eval_every, max_steps, k, epochs):
    """The sizes of the chunks ``fit`` hands to ``train_step_chunk`` equal
    the JAX ``fit``'s over batch counts, print and eval cadences,
    ``max_steps``, K and a short final batch."""
    monkeypatch.setattr(JL, "MetricsEngine", _StubEngine)
    monkeypatch.setattr(TL, "MetricsEngine", _StubEngine)
    config = tiny_config(print_every=print_every, eval_every=eval_every, steps_per_call=k,
                         n_epochs=epochs)
    loader = [{"poses": np.zeros((1 if short and i == n_batches - 1 else 2, 8, 66), np.float32),
               "seq_lengths": np.full(2, 8, np.int32), "ids": ["a", "b"]}
              for i in range(n_batches)]
    got, want = _StubTrainer(config), _StubTrainer(config)
    TL.fit(got, loader, [], [], str(tmp_path / "port"), max_steps=max_steps)
    JL.fit(want, loader, [], [], str(tmp_path / "jax"), max_steps=max_steps)
    assert got.chunks == want.chunks
    assert got.global_step == want.global_step
    assert max(got.chunks) <= k
