"""The slice as a whole: one LGD-RNN train step of the port against the JAX package.

IEF with an init RNN (2x32), the gradient input, shape averaging, N=2
refinement steps, iter MLPs 2x32 with BatchNorm, the FK loss, 6 and 12
markers. Params and BatchNorm state come from the JAX ``model.init`` and
cross over with ``state_dict_from_jax``. The batch mixes full, partial and
zero-length rows. Compared: the train loss and its parts (JAX
``forward(train=True)`` + ``compute_loss``, rescaled to the real samples),
every parameter gradient of ``loss + reference_grad_extra_loss`` by torch
key (``grads_from_jax``), and the BatchNorm running statistics after the
step. At batch 3 the JAX init RNN runs its scan, at batch 9 its Pallas
training pair in interpret mode.

Tolerance: losses rtol 1e-5; BatchNorm statistics atol 1e-5, rtol 1e-4;
gradients atol 1e-4 * (1 + max |JAX gradient|) per tensor. The refinement
input holds the reconstruction gradient scaled by n*f, which multiplies fp32
rounding differences of the FK (row-major in the port, lane-major in JAX) by
up to a few hundred before they reach the gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from empose_tpu.nn import layers as JL
from empose_tpu.nn.models import create_model as j_create_model

from empose_tpu_torch.checkpoint.from_jax import grads_from_jax, state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.nn.models import create_model
from tests.test_torch_checkpoint import BASE, _jax_params, sensors  # noqa: F401 (fixture)

torch.set_num_threads(1)
F = 8
TRAIN_CFG = dict(BASE, m_rnn_init=True, m_fk_loss=0.1, m_pose_loss_weight=10.0)


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, F + 1, n)
    lengths[0], lengths[-1] = F, 0
    offset_r = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(n * 12)])
    offset_r *= np.sign(np.linalg.det(offset_r))[:, None, None]
    return {
        "marker_pos": (rng.randn(n, F, 36) * 0.3).astype(np.float32),
        "marker_ori": (rng.randn(n, F, 108) * 0.3).astype(np.float32),
        "seq_lengths": lengths.astype(np.int32),
        "offset_t": (rng.randn(n, 12, 3) * 0.02).astype(np.float32),
        "offset_r": offset_r.reshape(n, 12, 3, 3).astype(np.float32),
        "poses": (rng.randn(n, F, 66) * 0.2).astype(np.float32),
        "shapes": (rng.randn(n, 10) * 0.3).astype(np.float32),
        "joints_gt": (rng.randn(n, F, 66) * 0.3).astype(np.float32),
    }


def _pad_scale(lengths):
    return lengths.shape[0] / max(int((lengths > 0).sum()), 1)


@pytest.mark.parametrize("n_markers", [6, 12])
@pytest.mark.parametrize("batch", [3, 9], ids=["scan", "pallas_interpret"])
def test_lgd_rnn_train_step_matches_jax(sensors, monkeypatch, n_markers, batch):
    if batch >= JL.LSTM_TRAIN_KERNEL_MIN_BATCH:
        monkeypatch.setattr(JL, "LSTM_TRAIN_KERNEL", "interpret")
    j_sensor, t_sensor = sensors
    cfg_dict = dict(TRAIN_CFG, n_markers=n_markers)
    cfg, params, state = _jax_params(cfg_dict, j_sensor, seed=n_markers + batch)
    t_cfg = Configuration.from_dict(cfg_dict)
    j_model = j_create_model(cfg, j_sensor)
    win = _batch(batch, seed=batch * n_markers)
    scale = _pad_scale(win["seq_lengths"])

    def loss_fn(p, w):
        out, new_state, _ = j_model.forward(p, state, w, train=True)
        total, vals = j_model.compute_loss(w, out)
        extra = j_model.reference_grad_extra_loss(out)
        return (total + extra) * scale, ({k: v * scale for k, v in vals.items()}, new_state)

    j_grads, (j_vals, j_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in win.items()})

    t_model = create_model(t_cfg, t_sensor).train()
    t_model.load_state_dict(state_dict_from_jax(params, state, t_cfg), strict=True)
    t_win = {k: torch.from_numpy(v.astype(np.int64) if k == "seq_lengths" else v)
             for k, v in win.items()}
    out, _ = t_model(t_win, None)
    total, vals = t_model.compute_loss(t_win, out)
    ((total + t_model.reference_grad_extra_loss(out)) * scale).backward()

    assert sorted(vals) == sorted(j_vals)
    for k, v in vals.items():
        np.testing.assert_allclose(float(v) * scale, float(j_vals[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = grads_from_jax(jax.device_get(j_grads), t_cfg)
    got = {k: p.grad for k, p in t_model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * (1.0 + np.abs(w).max()), err_msg=k)
    want_state = state_dict_from_jax(params, jax.device_get(j_state), t_cfg)
    buffers = dict(t_model.named_buffers())
    for k, w in want_state.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        elif k.endswith("num_batches_tracked"):
            # The iter nets are applied N times per step, the init nets once.
            assert int(buffers[k]) == (2 if "_iter" in k else 1), k


RNN_COMMON = dict(use_marker_pos=True, use_marker_ori=True, m_estimate_shape=True,
                  m_shape_hidden_size=8, m_average_shape=True, m_hidden_size=16, m_num_layers=2,
                  m_fk_loss=0.1, window_size=F, lr=1e-3)


@pytest.mark.parametrize("kind, n_markers, batch", [
    ("birnn", 6, 3), ("birnn", 12, 9), ("rnn_learn_init", 6, 9), ("resnet", 12, 3),
], ids=["birnn-scan", "birnn-pallas_interpret", "rnn_learn_init-pallas_interpret", "resnet"])
def test_rnn_and_resnet_train_step_matches_jax(sensors, monkeypatch, kind, n_markers, batch):
    """One train step of a SimpleRNN (bidirectional, or unidirectional with a
    learned initial state) and of FeedForwardResNet, dropout 0, FK loss 0.1:
    the loss and its parts and every parameter gradient against ``jax.grad``
    of the JAX train forward + ``compute_loss``. At batch 9 each JAX
    direction-layer runs its Pallas training pair in interpret mode."""
    if batch >= JL.LSTM_TRAIN_KERNEL_MIN_BATCH:
        monkeypatch.setattr(JL, "LSTM_TRAIN_KERNEL", "interpret")
    j_sensor, t_sensor = sensors
    extra = {"birnn": dict(m_type="rnn", m_bidirectional=True),
             "rnn_learn_init": dict(m_type="rnn", m_learn_init_state=True),
             "resnet": dict(m_type="resnet")}[kind]
    cfg_dict = dict(RNN_COMMON, n_markers=n_markers, **extra)
    cfg, params, state = _jax_params(cfg_dict, j_sensor, seed=n_markers + batch)
    t_cfg = Configuration.from_dict(cfg_dict)
    j_model = j_create_model(cfg, j_sensor)
    win = _batch(batch, seed=batch + n_markers)
    scale = _pad_scale(win["seq_lengths"])

    def loss_fn(p, w):
        out, _, _ = j_model.forward(p, state, w, train=True)
        total, vals = j_model.compute_loss(w, out)
        return total * scale, {k: v * scale for k, v in vals.items()}

    j_grads, j_vals = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in win.items()})

    t_model = create_model(t_cfg, t_sensor).train()
    t_model.load_state_dict(state_dict_from_jax(params, state, t_cfg), strict=True)
    t_win = {k: torch.from_numpy(v.astype(np.int64) if k == "seq_lengths" else v)
             for k, v in win.items()}
    out, _ = t_model(t_win, None)
    total, vals = t_model.compute_loss(t_win, out)
    (total * scale).backward()

    assert sorted(vals) == sorted(j_vals)
    for k, v in vals.items():
        np.testing.assert_allclose(float(v) * scale, float(j_vals[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = grads_from_jax(jax.device_get(j_grads), t_cfg)
    got = {k: p.grad for k, p in t_model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * (1.0 + np.abs(w).max()), err_msg=k)


def test_adam_matches_optax_flatten():
    """Three torch Adam steps (lr 1e-3, eps 1e-8) against
    ``optax.flatten(optax.adam)`` on the same gradients; atol 1e-7."""
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]

    opt = optax.flatten(optax.adam(1e-3))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = opt.init(j_params)
    for g in grads:
        updates, j_state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    t_opt = torch.optim.Adam(t_params.values(), lr=1e-3, eps=1e-8)
    for g in grads:
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k])
        t_opt.step()
    for k, p in t_params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_dropout_draws_from_the_generator():
    """Identity at eval, at p = 0 and without a generator; otherwise inverted
    dropout whose keep mask comes from the generator alone."""
    from empose_tpu_torch.nn.layers import dropout
    x = torch.randn(200, 50, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for p, training, gen in ((0.5, False, g), (0.0, True, g), (0.5, True, None)):
        assert dropout(x, p, training, gen) is x
    a = dropout(x, 0.25, True, torch.Generator().manual_seed(2))
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], x[kept] / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02  # 10000 draws: 4.6 standard errors
