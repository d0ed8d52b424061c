"""Why the port has no ``export_torch.py`` or ``convert_checkpoint.py``.

The JAX package needs ``tools/export_torch.py`` to turn its native (orbax)
checkpoint into a reference-layout ``model.pth``, and
``tools/convert_checkpoint.py`` for the way back. The port's
``Trainer.save`` writes ``model.pth`` itself, beside
``checkpoint/train_state.pt``, and its ``load_model`` evaluates that file.
These tests show that what the port writes is what the JAX tools read: a
port trainer at tiny widths trains 2 steps and saves into an experiment
dir; the JAX ``tools/convert_checkpoint.main`` (run unedited) converts that
dir's ``model.pth``; the JAX ``eval.harness.load_model`` loads the result;
and those parameters and BatchNorm statistics, carried back by
``checkpoint/from_jax.state_dict_from_jax``, equal the port model's
``state_dict`` bit for bit (all but BatchNorm's ``num_batches_tracked``
counters, which the JAX state does not keep and ``state_dict_from_jax``
sets to 0).
"""

import itertools
import os

import jax
import pytest
import torch

from empose_tpu.eval.harness import load_model as j_load_model
from tools.convert_checkpoint import main as j_convert_checkpoint

from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.tools.gate_common import host_batch
from empose_tpu_torch.train.loop import Trainer
from empose_tpu_torch.utils.experiments import load_model

torch.set_num_threads(1)

TINY = {
    "lgd": dict(m_type="ief", m_hidden_size=16, m_num_layers=1, m_num_iterations=2,
                m_use_gradient=True, m_average_shape=True, m_rnn_init=True,
                m_rnn_hidden_size=16, m_rnn_num_layers=1, m_fk_loss=0.1,
                m_reprojection_loss_weight=0.01, m_pose_loss_weight=10.0),
    "birnn": dict(m_type="rnn", m_bidirectional=True, m_hidden_size=16, m_num_layers=2,
                  m_estimate_shape=True, m_shape_hidden_size=8, m_average_shape=True),
    "resnet": dict(m_type="resnet", m_hidden_size=16, m_num_layers=2, m_estimate_shape=True,
                   m_shape_hidden_size=8, m_average_shape=True),
}


@pytest.mark.parametrize("family", sorted(TINY))
def test_jax_tools_read_what_the_port_saves(assets_env, tmp_path, family):
    cfg = Configuration.from_dict(dict(
        TINY[family], use_marker_pos=True, use_marker_ori=True, use_real_offsets=True,
        offset_noise_level=0, n_markers=6, window_size=16, bs_train=2, lr=1e-3, seed=3))
    trainer = Trainer(cfg, device="cpu")
    loader = EMRBatchLoader(os.path.join(assets_env, "data_synth", "amass_emr"), 2, 16, seed=5)
    for b in itertools.islice(iter(loader), 2):
        trainer.train_step(host_batch(b))
    experiments = str(tmp_path / "experiments")
    model_dir = os.path.join(experiments, f"940001-{family}")
    os.makedirs(model_dir)
    cfg.to_json(os.path.join(model_dir, "config.json"))
    trainer.save(model_dir)

    out = j_convert_checkpoint("940001", experiments)
    assert out == os.path.join(model_dir, "checkpoint_model") and os.path.isdir(out)
    _, params, state, j_cfg, j_dir, _ = j_load_model("940001", experiments)
    assert j_dir == model_dir and j_cfg.m_type == cfg.m_type
    got = state_dict_from_jax(jax.device_get(params), jax.device_get(state), cfg)
    want = trainer.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            # A torch counter of BatchNorm updates (momentum is fixed at 0.1,
            # so it changes no output); the JAX state has no counterpart.
            assert int(got[k]) == 0 and int(v) == 2 * cfg.m_num_iterations, k
            continue
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # The port evaluates the same file without any conversion.
    model, _, _ = load_model("940001", experiments, device="cpu")
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
