"""The slice as a whole: the port's LGD-RNN forward against the JAX package.

IEF with an init RNN (2x32), the gradient input and shape averaging, N=2
refinement steps, iter MLPs 2x32, 6 and 12 markers. Params come from the JAX
``model.init`` and cross over with ``state_dict_from_jax``. Two consecutive
windows with the LSTM carry threaded; every output, the whole history and
the new carry are compared. At batch 17 the JAX side runs its Pallas LSTM
kernel in interpret mode, at batch 3 its scan.

Tolerance atol 1e-4, rtol 1e-4: the refinement input holds the gradient of
the reconstruction error scaled by n*f, which multiplies fp32 rounding
differences of the FK by up to a few hundred.
"""

import numpy as np
import pytest
import torch

import jax

from empose_tpu.nn import layers as JL
from empose_tpu.nn.models import create_model as j_create_model

from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import create_model
from tests.test_torch_checkpoint import BASE, _jax_params, sensors  # noqa: F401 (fixture)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
F = 8


def _windows(n, seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, F + 1, n)
    lengths[0], lengths[-1] = F, 0
    offset_r = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(n * 12)])
    offset_r *= np.sign(np.linalg.det(offset_r))[:, None, None]
    base = {"offset_t": (rng.randn(n, 12, 3) * 0.02).astype(np.float32),
            "offset_r": offset_r.reshape(n, 12, 3, 3).astype(np.float32)}
    wins = []
    for w in range(2):
        win = dict(base)
        win["marker_pos"] = (rng.randn(n, F, 36) * 0.3).astype(np.float32)
        win["marker_ori"] = (rng.randn(n, F, 108) * 0.3).astype(np.float32)
        win["seq_lengths"] = (lengths if w == 0 else np.full(n, F)).astype(np.int32)
        wins.append(win)
    return wins


def _to_torch(win):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "seq_lengths" else v)
            for k, v in win.items()}


@pytest.mark.parametrize("n_markers", [6, 12])
@pytest.mark.parametrize("batch", [3, 17], ids=["scan", "pallas_interpret"])
def test_lgd_rnn_forward_two_windows(sensors, monkeypatch, n_markers, batch):
    if batch >= JL.LSTM_KERNEL_MIN_BATCH:
        monkeypatch.setattr(JL, "LSTM_KERNEL", "interpret")
    j_sensor, t_sensor = sensors
    cfg_dict = dict(BASE, m_rnn_init=True, n_markers=n_markers)
    cfg, params, state = _jax_params(cfg_dict, j_sensor, seed=n_markers)
    j_model = j_create_model(cfg, j_sensor)
    t_model = create_model(Configuration.from_dict(cfg_dict), t_sensor)
    t_model.load_state_dict(state_dict_from_jax(params, state, Configuration.from_dict(cfg_dict)),
                            strict=True)
    j_fwd = jax.jit(lambda p, s, w, c: j_model.forward(p, s, w, c)[::2])

    j_carry = t_carry = None
    for win in _windows(batch, seed=batch + n_markers):
        j_out, j_carry = j_fwd(params, state, win, j_carry)
        with torch.no_grad():
            t_out, t_carry = t_model(_to_torch(win), t_carry)
        for k in ("pose_hat", "root_ori_hat", "shape_hat", "joints_hat"):
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), err_msg=k, **TOL)
        assert sorted(t_out["history"]) == sorted(j_out["history"])
        for k, v in j_out["history"].items():
            assert t_out["history"][k].shape == v.shape, k
            np.testing.assert_allclose(t_out["history"][k].numpy(), np.asarray(v),
                                       err_msg=f"history {k}", **TOL)
        for t_c, j_c in zip(t_carry, j_carry):
            np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), **TOL)


def test_forward_refuses_training_and_unported_types(sensors):
    """Train mode runs (the history keeps its graph, one reconstruction error
    per refinement step); an unknown model type raises."""
    _, t_sensor = sensors
    model = create_model(Configuration.from_dict(dict(BASE, m_rnn_init=True)), t_sensor)
    init_parameters(model, torch.Generator().manual_seed(0)).train()
    win = _to_torch(_windows(3, seed=0)[0])
    out, _ = model(win, None)
    assert out["history"]["pose"].requires_grad and len(out["_recon_for_grad"]) == 2
    assert torch.isfinite(out["pose_hat"]).all()
    with pytest.raises(ValueError, match="unknown"):
        create_model(Configuration.from_dict(dict(BASE, m_type="transformer")), t_sensor)
