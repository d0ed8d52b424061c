"""``--remat`` and ``--profile_dir`` of the port's trainer, and its timers.

A tiny LGD model with 3 refinement steps takes one training step with and
without rematerialization of its FK blocks from the same state and batch:
the loss, each step's reconstruction error (``_recon_for_grad``), every
gradient and the BatchNorm statistics are equal bit for bit, at ``highest``
and at ``high``, and after the forward the graph holds less than half the
saved bytes with it. The train CLI runs with ``--remat`` (the same losses
as without) and writes a Chrome trace that parses with ``--profile_dir``;
``timeit_ms`` and ``timeit_chain`` count their calls.
"""

import gc
import glob
import json
import os
import weakref

import numpy as np
import pytest
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.device import set_precision
from empose_tpu_torch.train.cli import main as train_main
from empose_tpu_torch.train.loop import Trainer
from empose_tpu_torch.utils import profiling
from tests.test_torch_train_loop import TINY_LGD, _losses

torch.set_num_threads(1)
THREE_STEPS = ["--m_num_iterations", "3"]


def _step(remat: bool, precision: str, host_batch):
    """One step's forward and backward from the seed's state: (loss, loss
    values, recon terms, gradients, module buffers, bytes of the tensors
    that the graph saved outside a checkpoint and still holds after the
    forward)."""
    flags = TINY_LGD[:-2] + THREE_STEPS + ["--matmul_precision", precision]
    cfg = Configuration(vars(Configuration.parser().parse_args(
        flags + (["--remat"] if remat else []))))
    trainer = Trainer(cfg, device="cpu")
    saved = []

    def pack(x):
        saved.append(weakref.ref(x))
        return x

    batch = trainer.pre_train(trainer.upload(host_batch), trainer.generator, mode="all")
    model = trainer.model
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out, _ = model(batch, None, trainer.generator)
    gc.collect()
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in (ref() for ref in saved) if t is not None}
    total, vals = model.compute_loss(batch, out)
    loss = total + model.reference_grad_extra_loss(out)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    return loss, vals, out["_recon_for_grad"], grads, buffers, sum(held.values())


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_remat_step_is_bit_identical(assets_env, precision):
    loader = EMRBatchLoader(os.path.join(C.data_dir_synth(), "amass_emr"), 2, 16, shuffle=True,
                            seed=3, window_rng=np.random.RandomState(4313))
    host_batch = next(iter(loader))
    try:
        plain = _step(False, precision, host_batch)
        remat = _step(True, precision, host_batch)
    finally:
        set_precision("highest")
    assert torch.equal(remat[0], plain[0])
    for k, v in plain[1].items():
        assert torch.equal(remat[1][k], v), k
    assert len(remat[2]) == len(plain[2]) == 3
    for a, b in zip(remat[2], plain[2]):
        assert torch.equal(a, b)
    assert sorted(remat[3]) == sorted(plain[3]) and plain[3]
    for k, g in plain[3].items():
        assert torch.equal(remat[3][k], g), k
    for k, b in plain[4].items():
        assert torch.equal(remat[4][k], b), k
    # The FK blocks' activations stay out of the graph: it holds less.
    assert remat[5] < 0.5 * plain[5], (remat[5], plain[5])


def test_cli_remat_trains_as_without(assets_env, tmp_path, monkeypatch):
    """``--remat`` through the train CLI: 2 steps with the losses of the run
    without it, bit for bit, and the same weights."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    plain_dir, plain = train_main(TINY_LGD + ["--experiment_id", "780001", "--max_steps", "2"])
    remat_dir, remat = train_main(TINY_LGD + ["--experiment_id", "780002", "--max_steps", "2",
                                              "--remat"])
    assert _losses(remat_dir) == _losses(plain_dir) and sorted(_losses(plain_dir)) == [1, 2]
    for k, v in plain.model.state_dict().items():
        assert torch.equal(remat.model.state_dict()[k], v), k


def test_cli_profile_dir_writes_a_trace(assets_env, tmp_path, monkeypatch):
    """``--profile_dir``: one Chrome trace of the training that parses as
    JSON and holds the host's operators and the program's spans."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path / "experiments"))
    trace_dir = str(tmp_path / "trace")
    _, trainer = train_main(TINY_LGD + ["--experiment_id", "780003", "--max_steps", "2",
                                        "--profile_dir", trace_dir])
    assert trainer.global_step == 2
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::mm" in ops or "aten::addmm" in ops
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert any(name.startswith("Optimizer.step") for name in annotations)
    assert {"train.step", "train.forward", "lgd.fk"} <= annotations


def test_trace_without_dir_is_a_no_op_and_writes_on_error(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with pytest.raises(RuntimeError):
        with profiling.trace(str(tmp_path / "t")):
            with profiling.span("region"):
                torch.ones(4).sum()
            raise RuntimeError("stop")
    (path,) = glob.glob(str(tmp_path / "t" / "*.json"))
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert "region" in names


def test_timeit_ms_counts_its_calls():
    calls = []

    def fn(a):
        calls.append(1)
        return {"out": a * 2}

    ms = profiling.timeit_ms(fn, torch.ones(3), iters=5, warmup=2)
    assert ms >= 0 and len(calls) == 1 + 2 + 5


def test_timeit_chain_carries_and_counts_its_calls():
    """Each call takes the previous call's output; one untimed call,
    ``warmup`` warm calls and ``repeats`` blocks of ``iters``, as
    ``chain_calls`` counts them; ``timeit_ms`` is the same timer."""
    seen = []

    def step(carry):
        seen.append(int(carry))
        return carry + 1

    ms = profiling.timeit_chain(step, torch.zeros(()), iters=3, warmup=1, repeats=2)
    assert ms >= 0 and seen == list(range(profiling.chain_calls(iters=3, warmup=1, repeats=2)))
    assert len(seen) == 1 + 1 + 2 * 3
    calls = []
    profiling.timeit_ms(lambda a: calls.append(1) or a, torch.ones(2), iters=2, warmup=0,
                        repeats=3)
    assert len(calls) == profiling.chain_calls(iters=2, warmup=0, repeats=3) == 7
