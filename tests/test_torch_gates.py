"""The port's training gates (``empose_tpu_torch/tools/convergence_gate.py``,
``demo_convergence.py``, ``demo_resume.py`` and their shared
``gate_common.py``) on the CPU, on a copy of the asset tree of
``tests/conftest.py``.

The LGD-RNN-6 retrain config is shrunk to one layer of 16 units
(``lgd_retrain_config`` replaced in the tool's module; the tools take no
flag for it); the gate runs 3 steps and a kill/resume of 2 + 2. Resumes are
held bit for bit (0.0), since a resumed trainer continues bit for bit. The
gate's MPJPE pass is held against the JAX gate's ``mpjpe()`` code on the
same JAX-initialised weights (``checkpoint/from_jax.state_dict_from_jax``)
within 1e-3 mm.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from empose_tpu.config import Configuration as JConfiguration
from empose_tpu.data.batches import collate_real as j_collate_real
from empose_tpu.data.datasets import Loader as JLoader, RealDataset as JRealDataset
from empose_tpu.eval.metrics import MetricsEngine as JMetricsEngine
from empose_tpu.train.loop import Trainer as JTrainer

from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.device import set_precision
from empose_tpu_torch.nn.layers import nn_precision
from empose_tpu_torch.nn.models import fk_precision
from empose_tpu_torch.tools import convergence_gate as G
from empose_tpu_torch.tools import demo_convergence as DC
from empose_tpu_torch.tools import demo_resume as DR
from empose_tpu_torch.tools import gate_common as GC
from empose_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

TINY = dict(m_hidden_size=16, m_num_layers=1, m_rnn_hidden_size=16, m_rnn_num_layers=1)
JSON_KEYS = ["failures", "gate", "matmul_precision", "mpjpe_after_mm", "mpjpe_before_mm", "ok",
             "reference_example_s_per_step", "resume_max_loss_diff", "s_per_step", "steps"]


def tiny_retrain_config(**overrides):
    return GC.lgd_retrain_config(**TINY, **overrides)


@pytest.fixture()
def tree(assets_dir, tmp_path):
    """A copy of the conftest tree the tools may write into."""
    root = str(tmp_path / "assets")
    shutil.copytree(assets_dir, root)
    return root


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_gate_json_line_resume_and_experiment_dir(tree, monkeypatch, capsys):
    monkeypatch.setattr(G, "lgd_retrain_config", tiny_retrain_config)
    rc = G.main(["--steps", "3", "--resume_k", "2", "--assets", tree, "--device", "cpu"])
    out = capsys.readouterr().out
    result = _last_json(out)
    assert sorted(result) == JSON_KEYS
    assert rc == (0 if result["ok"] else 1)
    assert result["resume_max_loss_diff"] == 0.0
    assert result["steps"] == 3 and result["matmul_precision"] == "highest"
    assert result["s_per_step"] is not None and result["s_per_step"] > 0  # step 3
    assert result["mpjpe_before_mm"] > 0 and result["mpjpe_after_mm"] > 0
    stats = json.loads(next(line for line in out.splitlines()
                            if line.startswith("step times"))[len("step times (s, steps 3 on): "):])
    assert stats["n"] == 1 and stats["p25"] <= stats["median"] <= stats["p75"]
    model_dir = os.path.join(tree, "experiments", "920000-gate-lgd-rnn6-highest")
    for name in ("config.json", "model.pth", os.path.join("checkpoint", "train_state.pt")):
        assert os.path.exists(os.path.join(model_dir, name)), name
    # The environment is the caller's again.
    assert os.environ.get("EM_EXPERIMENTS") != os.path.join(tree, "experiments")


def test_gate_precision_reaches_the_trainers_knobs(tree, monkeypatch, capsys):
    seen = []

    class Spy(Trainer):
        def __init__(self, config, *args, **kwargs):
            super().__init__(config, *args, **kwargs)
            seen.append((config.matmul_precision, nn_precision(), fk_precision()))

    monkeypatch.setattr(G, "lgd_retrain_config", tiny_retrain_config)
    monkeypatch.setattr(G, "Trainer", Spy)
    try:
        G.main(["--steps", "1", "--resume_k", "1", "--assets", tree, "--device", "cpu",
                "--matmul_precision", "high", "--experiment_id", "930001"])
    finally:
        set_precision("highest")
    result = _last_json(capsys.readouterr().out)
    assert result["matmul_precision"] == "high" and result["s_per_step"] is None
    assert result["resume_max_loss_diff"] == 0.0
    assert seen == [("high", "high", "high")] * 4  # the gate's trainer, A, B and the control
    assert os.path.isdir(os.path.join(tree, "experiments", "930001-gate-lgd-rnn6-high"))


def test_gate_mpjpe_pass_matches_jax(assets_env):
    """The untrained MPJPE of a JAX trainer's initial weights through the
    port's pass equals the JAX gate's ``mpjpe()`` within 1e-3 mm."""
    cfg = dict(tiny_retrain_config().__dict__)
    j_trainer = JTrainer(JConfiguration.from_dict(cfg), seed=17)
    me = JMetricsEngine(j_trainer.smplh)
    j_trainer.evaluate_test(JLoader(JRealDataset(os.environ["EM_DATA_REAL"]), 1, j_collate_real,
                                    shuffle=False), me, 256)
    want = float(me.get_metrics()["MPJPE [mm]"])

    t_cfg = tiny_retrain_config()
    trainer = Trainer(t_cfg, seed=17, device="cpu")
    trainer.model.load_state_dict(state_dict_from_jax(jax.device_get(j_trainer.params),
                                                      jax.device_get(j_trainer.state), t_cfg),
                                  strict=True)
    got = GC.mpjpe_fn(trainer, 256)()
    assert want > 50.0
    assert abs(got - want) <= 1e-3, (got, want)


def test_asset_env_writes_a_missing_tree_and_restores_the_environment(tmp_path, monkeypatch):
    monkeypatch.setattr(GC, "GATE_TREE", dict(n_real_sequences=1, n_amass_sequences=2,
                                              n_frames=24, seed=3))
    monkeypatch.setenv("EM_DATA_REAL", "/elsewhere")
    monkeypatch.delenv("EM_EXPERIMENTS", raising=False)
    root = str(tmp_path / "new_tree")
    with GC.asset_env(root, "cpu") as d:
        assert d == root
        assert os.environ["EM_DATA_REAL"] == os.path.join(root, "data_real")
        assert os.environ["EM_EXPERIMENTS"] == os.path.join(root, "experiments")
        assert os.path.exists(os.path.join(root, "data_real", "0402_seq0_clean.npz"))
        assert os.path.exists(os.path.join(root, "data_synth", "amass_emr", "corpus.emr"))
    assert os.environ["EM_DATA_REAL"] == "/elsewhere"
    assert "EM_EXPERIMENTS" not in os.environ


def test_demo_convergence_runs(tree, capsys):
    result = DC.main(["--steps", "3", "--assets", tree, "--device", "cpu"])
    out = capsys.readouterr().out
    assert result["steps"] == 3 and np.isfinite(result["last_loss"])
    assert np.isfinite(result["mpjpe_before_mm"]) and np.isfinite(result["mpjpe_after_mm"])
    assert result["mpjpe_before_mm"] != result["mpjpe_after_mm"]
    assert "MPJPE before:" in out and "MPJPE after 3 steps:" in out


def test_demo_resume_is_seamless(tree, monkeypatch, capsys):
    monkeypatch.setattr(DR, "lgd_retrain_config", tiny_retrain_config)
    rc = DR.main(["--k", "3", "--assets", tree, "--device", "cpu"])
    out = capsys.readouterr().out
    result = _last_json(out)
    assert rc == 0 and result["ok"]
    assert result["pre_checkpoint_max_loss_diff"] == 0.0
    assert result["post_resume_max_loss_diff"] == 0.0
    assert result["step_s"]["n"] == 2 and result["valid_pass_s"] > 0
    assert "RESUME SEAMLESS" in out
    assert os.path.exists(os.path.join(tree, "resume_ckpt", "checkpoint", "train_state.pt"))
