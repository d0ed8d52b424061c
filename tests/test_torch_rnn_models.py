"""The port's SimpleRNN (uni- and bidirectional) and FeedForwardResNet
against the JAX package: eval forward over two windows with the carry, the
loss values, and the parameter counts of the released widths.

Small widths (LSTM 2x16, ResNet 2x16, shape MLP 8), weights from the JAX
``model.init`` carried over with ``state_dict_from_jax``. At batch 17 the JAX
LSTM runs its Pallas kernels in interpret mode (the bidirectional layer
kernel for a BiRNN), at batch 3 its scan. Tolerance atol 5e-5, rtol 1e-5:
fp32 on both sides, another summation order, no learned-gradient input.
"""

import numpy as np
import pytest
import torch

import jax

from empose_tpu.config import Configuration as JConfiguration
from empose_tpu.nn import layers as JL
from empose_tpu.nn.models import create_model as j_create_model

from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.nn.models import create_model
from empose_tpu_torch.utils.experiments import count_parameters
from tests.test_torch_checkpoint import _jax_params, sensors  # noqa: F401 (fixture)

torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-5)
F = 8
COMMON = dict(use_marker_pos=True, use_marker_ori=True, m_estimate_shape=True,
              m_shape_hidden_size=8, m_average_shape=True, m_hidden_size=16, m_num_layers=2,
              window_size=F, lr=1e-3)
KINDS = {
    "birnn": dict(COMMON, m_type="rnn", m_bidirectional=True),
    "rnn": dict(COMMON, m_type="rnn"),
    "rnn_learn_init": dict(COMMON, m_type="rnn", m_learn_init_state=True),
    "resnet": dict(COMMON, m_type="resnet"),
}


def _batch(n, seed):
    """Two windows: full, partial and zero-length rows in the first; the
    second full. Ground truth for the losses rides along."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, F + 1, n)
    lengths[0], lengths[-1] = F, 0
    wins = []
    for w in range(2):
        wins.append({
            "marker_pos": (rng.randn(n, F, 36) * 0.3).astype(np.float32),
            "marker_ori": (rng.randn(n, F, 108) * 0.3).astype(np.float32),
            "seq_lengths": (lengths if w == 0 else np.full(n, F)).astype(np.int32),
            "offset_t": np.zeros((n, 12, 3), np.float32),
            "offset_r": np.broadcast_to(np.eye(3, dtype=np.float32), (n, 12, 3, 3)).copy(),
            "poses": (rng.randn(n, F, 66) * 0.2).astype(np.float32),
            "shapes": (rng.randn(n, 10) * 0.3).astype(np.float32),
            "joints_gt": (rng.randn(n, F, 66) * 0.3).astype(np.float32),
        })
    return wins


def _to_torch(win):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "seq_lengths" else v)
            for k, v in win.items()}


def _pair(sensors, cfg_dict, seed):
    j_sensor, t_sensor = sensors
    cfg, params, state = _jax_params(cfg_dict, j_sensor, seed=seed)
    t_cfg = Configuration.from_dict(cfg_dict)
    t_model = create_model(t_cfg, t_sensor)
    t_model.load_state_dict(state_dict_from_jax(params, state, t_cfg), strict=True)
    return j_create_model(cfg, j_sensor), params, state, t_model


@pytest.mark.parametrize("kind, n_markers, fk, batch", [
    ("birnn", 6, 0.0, 17), ("birnn", 12, 0.1, 3), ("birnn", 12, 0.0, 17),
    ("rnn", 6, 0.1, 17), ("rnn", 12, 0.0, 3),
    ("rnn_learn_init", 6, 0.0, 3), ("rnn_learn_init", 12, 0.1, 17),
    ("resnet", 6, 0.1, 3), ("resnet", 12, 0.0, 3),
])
def test_eval_forward_two_windows(sensors, monkeypatch, kind, n_markers, fk, batch):
    if batch >= JL.LSTM_KERNEL_MIN_BATCH:
        monkeypatch.setattr(JL, "LSTM_KERNEL", "interpret")
    cfg_dict = dict(KINDS[kind], n_markers=n_markers, m_fk_loss=fk)
    j_model, params, state, t_model = _pair(sensors, cfg_dict, seed=n_markers + batch)
    j_fwd = jax.jit(lambda p, s, w, c: j_model.forward(p, s, w, c)[::2])
    j_carry = t_carry = None
    for win in _batch(batch, seed=batch + n_markers):
        j_out, j_carry = j_fwd(params, state, win, j_carry)
        with torch.no_grad():
            t_out, t_carry = t_model(_to_torch(win), t_carry)
        assert sorted(t_out) == sorted(j_out)
        for k, v in j_out.items():
            if v is None:
                assert t_out[k] is None, k
                continue
            assert tuple(t_out[k].shape) == v.shape, k
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(v), err_msg=k, **TOL)
        assert (t_carry is None) == (j_carry is None)
        for t_c, j_c in zip(t_carry or (), j_carry or ()):
            np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), **TOL)


@pytest.mark.parametrize("kind", ["birnn", "resnet"])
def test_compute_loss_matches_jax(sensors, kind):
    """Pose/root MSE, shape L1 and the FK term on a batch with a zero-length row."""
    cfg_dict = dict(KINDS[kind], n_markers=6, m_fk_loss=0.1)
    j_model, params, state, t_model = _pair(sensors, cfg_dict, seed=4)
    win = _batch(5, seed=4)[0]
    j_out = j_model.forward(params, state, win)[0]
    j_total, j_vals = j_model.compute_loss(win, j_out)
    with torch.no_grad():
        t_win = _to_torch(win)
        t_total, t_vals = t_model.compute_loss(t_win, t_model(t_win)[0])
    assert sorted(t_vals) == sorted(j_vals)
    for k, v in j_vals.items():
        np.testing.assert_allclose(float(t_vals[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(t_vals["fk"]) > 0.0 and float(t_total) == float(t_vals["total_loss"])


# The released BiRNN and ResNet checkpoints' widths (tests/test_released_configs.py)
# and their parameter counts in the JAX package.
RELEASED = {
    ("rnn", 6): 9_295_697, ("rnn", 12): 9_590_609,
    ("resnet", 6): 498_769, ("resnet", 12): 517_201,
}


@pytest.mark.parametrize("m_type, n_markers", sorted(RELEASED))
def test_released_parameter_counts(sensors, m_type, n_markers):
    _, t_sensor = sensors
    cfg = dict(use_marker_pos=True, use_marker_ori=True, n_markers=n_markers, m_type=m_type,
               m_estimate_shape=True, m_shape_hidden_size=256, m_average_shape=True,
               m_num_layers=2)
    if m_type == "rnn":
        cfg.update(m_bidirectional=True, m_hidden_size=512)
    else:
        cfg.update(m_hidden_size=256)
    model = create_model(Configuration.from_dict(cfg), t_sensor)
    assert count_parameters(model) == RELEASED[(m_type, n_markers)]


@pytest.mark.parametrize("kind", ["birnn", "rnn", "resnet"])
def test_model_name_matches_jax(sensors, kind):
    """The experiment-directory summary of the JAX package."""
    j_sensor, t_sensor = sensors
    cfg_dict = dict(KINDS[kind], n_markers=6, m_fk_loss=0.1)
    want = j_create_model(JConfiguration.from_dict(cfg_dict), j_sensor).model_name()
    assert create_model(Configuration.from_dict(cfg_dict), t_sensor).model_name() == want
    assert want.startswith({"birnn": "BiRNN-16-16-shape8-avg-fk0.1-n6",
                            "rnn": "RNN-16-16-shape8", "resnet": "ResNet-2x16-shape8"}[kind])
