"""Weights carried from the JAX package into the port, and model.pth loading."""

import numpy as np
import pytest
import torch

import jax

from empose_tpu.bodymodel.smplh import SMPLHModel as JSMPLHModel
from empose_tpu.bodymodel.synthetic import make_synthetic_smplh
from empose_tpu.checkpoint.torch_writer import export_model, save_torch_checkpoint
from empose_tpu.config import Configuration as JConfiguration
from empose_tpu.nn.models import SensorSMPL as JSensorSMPL, create_model as j_create_model

from empose_tpu_torch.bodymodel.smplh import SMPLHModel
from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.utils.experiments import load_model

torch.set_num_threads(1)

BASE = dict(m_type="ief", m_use_gradient=True, m_average_shape=True, m_num_iterations=2,
            m_hidden_size=32, m_num_layers=2, m_rnn_hidden_size=32, m_rnn_num_layers=2,
            use_marker_pos=True, use_marker_ori=True, n_markers=6, window_size=8, lr=1e-3)
VARIANTS = {
    "lgd_rnn": dict(BASE, m_rnn_init=True),
    "ief_mlp_bn": dict(BASE, m_rnn_init=False, n_markers=12),
    "ief_no_bn_skip": dict(BASE, m_rnn_init=False, m_no_batch_norm=True, m_skip_connections=True),
    "birnn": dict(BASE, m_type="rnn", m_bidirectional=True, m_estimate_shape=True,
                  m_shape_hidden_size=16),
    "rnn_learn_init": dict(BASE, m_type="rnn", m_learn_init_state=True, n_markers=12),
    "resnet_skip": dict(BASE, m_type="resnet", m_estimate_shape=True, m_shape_hidden_size=16,
                        m_skip_connections=True),
}


def synthetic_models():
    """The synthetic SMPL-H (seed 0) as a JAX and a port model, same arrays."""
    npz = make_synthetic_smplh(seed=0)
    pd = npz["posedirs"]
    arrays = dict(
        v_template=np.asarray(npz["v_template"], np.float32),
        shapedirs=np.asarray(npz["shapedirs"][..., :10], np.float32),
        posedirs=np.asarray(pd.reshape(-1, pd.shape[-1]).T, np.float32),
        j_regressor=np.asarray(npz["J_regressor"], np.float32),
        weights=np.asarray(npz["weights"], np.float32),
        parents=tuple(int(p) if p < 2 ** 31 else -1 for p in npz["kintree_table"][0]),
        faces=np.asarray(npz["f"], np.int64))
    return JSMPLHModel(**arrays), SMPLHModel(**arrays)


@pytest.fixture(scope="module")
def sensors():
    j_model, t_model = synthetic_models()
    return JSensorSMPL(j_model), SensorSMPL(t_model)


def _jax_params(cfg_dict, j_sensor, seed=0):
    """JAX-initialized params; BN running stats perturbed so the state map is exercised."""
    cfg = JConfiguration.from_dict(cfg_dict)
    params, state = j_create_model(cfg, j_sensor).init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    state = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.abs(rng.randn(*a.shape)).astype(np.float32) * 0.1, state)
    return cfg, jax.device_get(params), state


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_from_jax_matches_torch_writer(sensors, variant):
    j_sensor, t_sensor = sensors
    cfg, params, state = _jax_params(VARIANTS[variant], j_sensor)
    want = export_model(params, state, cfg)
    got = state_dict_from_jax(params, state, Configuration.from_dict(VARIANTS[variant]))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    model = create_model(Configuration.from_dict(VARIANTS[variant]), t_sensor)
    model.load_state_dict(got, strict=True)
    assert sorted(model.state_dict()) == sorted(want)


def test_load_model_reads_jax_written_pth(sensors, tmp_path, monkeypatch):
    """A model.pth written by the JAX package's save_torch_checkpoint loads
    through the port's load_model with strict=True, weights intact."""
    j_sensor, _ = sensors
    smpl_dir = tmp_path / "smpl_models" / "smplh_amass" / "neutral"
    smpl_dir.mkdir(parents=True)
    np.savez(smpl_dir / "model.npz", **make_synthetic_smplh(seed=0))
    monkeypatch.setenv("SMPL_MODELS", str(tmp_path / "smpl_models"))
    exp = tmp_path / "experiments" / "800001-LGD-test"
    exp.mkdir(parents=True)
    cfg, params, state = _jax_params(VARIANTS["lgd_rnn"], j_sensor, seed=3)
    cfg.to_json(str(exp / "config.json"))
    save_torch_checkpoint(str(exp / "model.pth"), params, state, cfg)

    model, config, model_dir = load_model("800001", experiment_dir=str(tmp_path / "experiments"),
                                          device="cpu")
    assert model_dir == str(exp) and config.m_rnn_init and not model.training
    want = export_model(params, state, cfg)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), np.asarray(want[k])), k

    native_only = tmp_path / "experiments" / "800002-native"
    (native_only / "checkpoint_model").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="export_torch.py"):
        load_model("800002", experiment_dir=str(tmp_path / "experiments"), device="cpu")
    with pytest.raises(FileNotFoundError, match="No experiment dir"):
        load_model("800003", experiment_dir=str(tmp_path / "experiments"), device="cpu")
