"""The port's training loop: the EMR batch loader against the JAX package's,
the CLI on the CPU at tiny widths (experiment directory, checkpoint, resume,
refusals).

The asset tree is the synthetic one of ``tests/conftest.py``
(``assets_dir``: SMPL-H, per-subject offsets, a 3-sequence AMASS-style EMR
corpus of 40 frames).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from empose_tpu.data.datasets import EMRBatchLoader as JEMRBatchLoader

from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.ops import lstm_train_kernel as K
from empose_tpu_torch.train.cli import main
from empose_tpu_torch.utils.experiments import load_model

torch.set_num_threads(1)

TINY_LGD = ["--m_type", "lgd", "--m_rnn_init", "--m_use_gradient", "--m_average_shape",
            "--m_num_iterations", "2", "--m_hidden_size", "16", "--m_num_layers", "1",
            "--m_rnn_hidden_size", "16", "--m_rnn_num_layers", "2", "--m_fk_loss", "0.1",
            "--use_marker_pos", "--use_marker_ori", "--use_real_offsets", "--n_markers", "6",
            "--window_size", "16", "--bs_train", "2", "--n_epochs", "5", "--print_every", "2",
            "--eval_every", "1000000", "--seed", "3", "--lr", "1e-3", "--device", "cpu"]


def _corpus(assets_dir):
    return os.path.join(assets_dir, "data_synth", "amass_emr")


@pytest.mark.parametrize("prefetch", [0, 2])
def test_emr_batch_loader_matches_jax(assets_dir, prefetch):
    """Same seeds, same shuffles and crops: byte-identical batches, over
    three epochs."""
    kw = dict(batch_size=2, window_size=16, shuffle=True, seed=5, window_mode="random",
              prefetch=prefetch)
    want = JEMRBatchLoader(_corpus(assets_dir), window_rng=np.random.RandomState(4313), **kw)
    got = EMRBatchLoader(_corpus(assets_dir), window_rng=np.random.RandomState(4313), **kw)
    assert len(got) == len(want) == 2
    for _ in range(3):
        pairs = list(zip(got, want))
        assert len(pairs) == 2
        for g, w in pairs:
            assert sorted(g) == sorted(w)
            assert g["ids"] == w["ids"]
            for k in w:
                if k != "ids":
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_fast_forward_continues_the_stream(assets_dir):
    def loader():
        return EMRBatchLoader(_corpus(assets_dir), 2, 16, seed=1,
                              window_rng=np.random.RandomState(2))

    ref = loader()
    stream = [b for _ in range(3) for b in ref]
    ff = loader()
    ff.fast_forward(3)  # one epoch and one batch
    rest = [b for _ in range(2) for b in ff][:3]
    for g, w in zip(rest, stream[3:]):
        assert g["ids"] == w["ids"] and np.array_equal(g["poses"], w["poses"])


def _losses(model_dir):
    with open(os.path.join(model_dir, "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "train/total_loss"}


def test_cli_trains_and_writes_experiment_dir(assets_env, tmp_path, monkeypatch):
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    fwd, bwd = K.FWD_LAUNCHES, K.BWD_LAUNCHES
    model_dir, trainer = main(TINY_LGD + ["--experiment_id", "700001", "--max_steps", "3"])
    assert trainer.global_step == 3
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (fwd, bwd)  # the CPU runs the plain pair
    assert os.path.basename(model_dir).startswith("700001-IEF-1x16-N2-RNN-2x16-")
    for name in ("config.json", "cmd.txt", "code.zip", "model.pth",
                 os.path.join("checkpoint", "train_state.pt")):
        assert os.path.exists(os.path.join(model_dir, name)), name
    losses = _losses(model_dir)
    assert sorted(losses) == [1, 2, 3] and all(np.isfinite(v) for v in losses.values())
    # The reference-layout model.pth serves: load_model rebuilds the trained weights.
    model, config, _ = load_model("700001", device="cpu")
    assert config.m_rnn_hidden_size == 16
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_resume_matches_uninterrupted_run(assets_env, tmp_path, monkeypatch):
    """3 steps, then --resume to 6 (across an epoch boundary): the resumed
    steps' losses and the final weights equal an uninterrupted 6-step run
    bit for bit."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    full_dir, full = main(TINY_LGD + ["--experiment_id", "700002", "--max_steps", "6"])
    main(TINY_LGD + ["--experiment_id", "700003", "--max_steps", "3"])
    part_dir, resumed = main(TINY_LGD + ["--experiment_id", "700003", "--max_steps", "6",
                                         "--resume"])
    assert resumed.global_step == 6
    want, got = _losses(full_dir), _losses(part_dir)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5, 6]
    assert got == want
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


TINY_BIRNN = ["--m_type", "rnn", "--m_bidirectional", "--m_hidden_size", "16",
              "--m_num_layers", "2", "--m_estimate_shape", "--m_shape_hidden_size", "8",
              "--m_average_shape", "--m_fk_loss", "0.1", "--m_dropout", "0.1",
              "--m_dropout_hidden", "0.1", "--use_marker_pos", "--use_marker_ori",
              "--use_real_offsets", "--n_markers", "6", "--window_size", "16", "--bs_train", "2",
              "--n_epochs", "5", "--print_every", "2", "--eval_every", "1000000", "--seed", "4",
              "--lr", "1e-3", "--device", "cpu"]


def test_birnn_resume_matches_uninterrupted_run(assets_env, tmp_path, monkeypatch):
    """A tiny BiRNN with dropout through the CLI: 2 steps, then --resume to
    3, equal an uninterrupted 3-step run bit for bit (losses and weights);
    the experiment dir carries the SimpleRNN summary."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    full_dir, full = main(TINY_BIRNN + ["--experiment_id", "700006", "--max_steps", "3"])
    assert os.path.basename(full_dir).startswith("700006-BiRNN-16-16-shape8-avg-fk0.1-n6-")
    main(TINY_BIRNN + ["--experiment_id", "700007", "--max_steps", "2"])
    part_dir, resumed = main(TINY_BIRNN + ["--experiment_id", "700007", "--max_steps", "3",
                                           "--resume"])
    assert resumed.global_step == 3
    want, got = _losses(full_dir), _losses(part_dir)
    assert sorted(got) == sorted(want) == [1, 2, 3]
    assert got == want and all(np.isfinite(v) for v in got.values())
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_seed_zero_is_a_seed(assets_env):
    """Seed 0 seeds the run (the JAX trainer reads it as unset and takes the
    clock): two trainers built with it start from the same weights and draws."""
    from empose_tpu_torch.config import Configuration
    from empose_tpu_torch.train.loop import Trainer
    cfg = Configuration.parser().parse_args(TINY_LGD[:-2] + ["--seed", "0"])
    a, b = (Trainer(Configuration(vars(cfg)), device="cpu") for _ in range(2))
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_existing_id_without_load_raises(assets_env, tmp_path, monkeypatch):
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    os.makedirs(tmp_path / "700004-earlier")
    with pytest.raises(ValueError, match="--load"):
        main(TINY_LGD + ["--experiment_id", "700004", "--max_steps", "1"])
    with pytest.raises(ValueError, match="Cannot find"):
        main(TINY_LGD + ["--experiment_id", "700005", "--max_steps", "1", "--resume"])


@pytest.mark.parametrize("flags, error", [
    (["--remat"], None),
    (["--bf16", "--matmul_precision", "high"], ValueError),
    (["--dp_devices", "2"], NotImplementedError),
    (["--suppression_noise_length", "0.5"], None),
], ids=["remat", "bf16_conflict", "data_parallel", "noise"])
def test_unported_paths_raise(assets_env, tmp_path, monkeypatch, flags, error):
    """Data parallelism raises before any step, naming what is missing; so
    does ``--bf16`` beside another explicit precision (as in JAX).
    Rematerialization and noise, which raised until they were ported, now
    train and checkpoint (their checks: ``tests/test_torch_remat.py``,
    ``tests/test_torch_robustness.py``). Training at ``high`` and
    ``default`` runs (``tests/test_torch_train_precision.py``)."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    if error is None:
        _, trainer = main(TINY_LGD + ["--max_steps", "4"] + flags)
        assert trainer.global_step == 4
        assert len(glob.glob(os.path.join(tmp_path, "*", "checkpoint"))) == 1
        return
    with pytest.raises(error, match="ROADMAP|bf16|precision"):
        main(TINY_LGD + ["--max_steps", "4"] + flags)
    assert not glob.glob(os.path.join(tmp_path, "*", "checkpoint"))
