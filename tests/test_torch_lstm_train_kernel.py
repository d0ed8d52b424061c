"""The port's LSTM training pair (plain versions of the CUDA kernels) against
the JAX package.

References: ``empose_tpu.ops.lstm_train_kernel`` (``_pallas_fwd``,
``_pallas_bwd`` and ``lstm_cell_train_pallas``) in Pallas interpret mode, and
``empose_tpu.nn.layers._lstm_cell_scan`` differentiated by JAX. Lengths mix
full, empty, partial and one-frame rows; h0/c0 are non-zero. Tolerance atol
1e-5, rtol 1e-5: fp32 on both sides, the same formulas, another matmul
summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from empose_tpu.nn import layers as JL
from empose_tpu.ops import lstm_train_kernel as JK

from empose_tpu_torch.nn import layers as TL
from empose_tpu_torch.ops import lstm_train_kernel as K

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
F, N, I, H = 9, 5, 7, 32
LENGTHS = np.array([9, 0, 4, 9, 1])
CELL_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _case(seed):
    rng = np.random.RandomState(seed)
    b = 1.0 / np.sqrt(H)
    cell = {k: rng.uniform(-b, b, s).astype(np.float32) for k, s in
            (("w_ih", (I, 4 * H)), ("w_hh", (H, 4 * H)), ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
    x = rng.randn(F, N, I).astype(np.float32)
    mask = (np.arange(F)[:, None] < LENGTHS[None, :]).astype(np.float32)
    h0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    w_out = rng.randn(F, N, H).astype(np.float32)
    w_h, w_c = rng.randn(N, H).astype(np.float32), rng.randn(N, H).astype(np.float32)
    return cell, x, mask, h0, c0, (w_out, w_h, w_c)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_forward_sweep_matches_pallas_fwd():
    cell, x, mask, h0, c0, _ = _case(0)
    x_proj = x @ cell["w_ih"] + cell["b_ih"] + cell["b_hh"]
    want = JK._pallas_fwd(jnp.asarray(x_proj), jnp.asarray(mask)[:, :, None],
                          jnp.asarray(cell["w_hh"]), jnp.asarray(h0), jnp.asarray(c0),
                          hidden=H, interpret=True, precision=lax.Precision.HIGHEST)
    got = K.lstm_train_fwd(_t(x_proj), _t(mask), _t(cell["w_hh"]), _t(h0), _t(c0))
    for name, g, w in zip(("gates", "h_all", "c_all"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    _, h_all, c_all = got
    assert torch.equal(h_all[:, 1], _t(h0)[1].expand(F, H))  # the empty row stays frozen
    assert torch.equal(c_all[:, 1], _t(c0)[1].expand(F, H))
    no_gates = K.lstm_train_fwd(_t(x_proj), _t(mask), _t(cell["w_hh"]), _t(h0), _t(c0),
                                save_gates=False)
    assert no_gates[0] is None and torch.equal(no_gates[1], h_all)


def test_reverse_sweep_matches_pallas_bwd():
    cell, x, mask, h0, c0, _ = _case(1)
    rng = np.random.RandomState(11)
    x_proj = x @ cell["w_ih"] + cell["b_ih"] + cell["b_hh"]
    gates, _, c_all = K.lstm_train_fwd(_t(x_proj), _t(mask), _t(cell["w_hh"]), _t(h0), _t(c0))
    c_prev = torch.cat([_t(c0)[None], c_all[:-1]]).numpy()
    dh_all = rng.randn(F, N, H).astype(np.float32)
    dc_all = rng.randn(F, N, H).astype(np.float32)
    want = JK._pallas_bwd(jnp.asarray(dh_all), jnp.asarray(dc_all), jnp.asarray(gates.numpy()),
                          jnp.asarray(c_prev), jnp.asarray(mask)[:, :, None],
                          jnp.asarray(cell["w_hh"]), hidden=H, interpret=True,
                          precision=lax.Precision.HIGHEST)
    got = K.lstm_train_bwd(_t(dh_all), _t(dc_all), gates, _t(c_prev), _t(mask), _t(cell["w_hh"]))
    for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    # The empty row: zero dgates, cotangents passed straight through.
    assert torch.equal(got[0][:, 1], torch.zeros(F, 4 * H))
    np.testing.assert_allclose(got[1][1].numpy(), dh_all[:, 1].sum(0), rtol=1e-6, atol=1e-6)


def _jax_cell_fn(ref):
    if ref == "pallas_interpret":
        return lambda c, x, m, h0, c0: JK.lstm_cell_train_pallas(
            c, x, m, h0, c0, precision=lax.Precision.HIGHEST, interpret=True)
    return JL._lstm_cell_scan


@pytest.mark.parametrize("ref", ["pallas_interpret", "scan"])
def test_cell_train_forward_and_gradients_match_jax(ref):
    """Outputs and both finals, and the gradients of a loss touching all
    three with respect to x, every cell parameter, h0 and c0."""
    cell, x, mask, h0, c0, (w_out, w_h, w_c) = _case(2)
    jax_cell = _jax_cell_fn(ref)

    def j_loss(cell, x, h0, c0):
        outs, (hF, cF) = jax_cell(cell, x, jnp.asarray(mask), h0, c0)
        return jnp.sum(outs * w_out) + jnp.sum(hF * w_h) + jnp.sum(cF * w_c), (outs, hF, cF)

    (_, j_fwd), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        {k: jnp.asarray(v) for k, v in cell.items()}, jnp.asarray(x), jnp.asarray(h0),
        jnp.asarray(c0))

    t_cell = {k: _t(v, True) for k, v in cell.items()}
    t_x, t_h0, t_c0 = _t(x, True), _t(h0, True), _t(c0, True)
    outs, (hF, cF) = K.lstm_cell_train(t_cell, t_x, _t(mask), t_h0, t_c0)
    loss = (outs * _t(w_out)).sum() + (hF * _t(w_h)).sum() + (cF * _t(w_c)).sum()
    loss.backward()

    for name, g, w in zip(("outs", "hF", "cF"), (outs, hF, cF), j_fwd):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), err_msg=name, **TOL)
    for k in CELL_KEYS:
        np.testing.assert_allclose(t_cell[k].grad.numpy(), np.asarray(j_grads[0][k]),
                                   err_msg=f"d{k}", **TOL)
    for name, t, w in (("dx", t_x, j_grads[1]), ("dh0", t_h0, j_grads[2]), ("dc0", t_c0, j_grads[3])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_plain_pair_gradcheck_float64():
    """The plain reverse sweep is the exact gradient of the plain forward
    sweep: ``torch.autograd.gradcheck`` in float64 over the autograd function."""
    g = torch.Generator().manual_seed(3)
    f, n, h = 6, 4, 5
    lengths = torch.tensor([6, 0, 3, 1])
    mask = (torch.arange(f)[:, None] < lengths[None]).double()
    args = (torch.randn(f, n, 4 * h, dtype=torch.float64, generator=g),
            torch.randn(h, 4 * h, dtype=torch.float64, generator=g) * 0.4,
            torch.randn(n, h, dtype=torch.float64, generator=g) * 0.5,
            torch.randn(n, h, dtype=torch.float64, generator=g) * 0.5)
    args = tuple(a.requires_grad_() for a in args)

    def core(x_proj, w_hh, h0, c0):
        return K.LSTMCore.apply(x_proj, mask, w_hh, h0, c0, K.lstm_train_fwd, K.lstm_train_bwd)

    assert torch.autograd.gradcheck(core, args)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bidi"])
def test_lstm_apply_training_matches_jax(bidirectional):
    """A 2-layer stack in training mode (every direction-layer through the
    training pair), its outputs, finals and input gradient against JAX
    ``lstm_apply(inference=False)`` at batch 9 with the pair in interpret mode."""
    rng = np.random.RandomState(4)
    n = 9
    params = JL.lstm_init(jax.random.PRNGKey(5), I, H, 2, bidirectional)
    lstm = TL.LSTM(I, H, 2, bidirectional)
    sd = {}
    for l, layer in enumerate(params["layers"]):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if d in layer:
                for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh")):
                    sd[f"{name}_l{l}{suffix}"] = torch.from_numpy(np.asarray(layer[d][k]).T.copy())
                for k, name in (("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                    sd[f"{name}_l{l}{suffix}"] = torch.from_numpy(np.array(layer[d][k]))
    lstm.load_state_dict(sd)
    x = rng.randn(n, F, I).astype(np.float32)
    lengths = np.array([9, 0, 4, 9, 1, 7, 9, 2, 5])
    dirs = 2 if bidirectional else 1
    w_out = rng.randn(n, F, H * dirs).astype(np.float32)

    old = JL.LSTM_TRAIN_KERNEL
    JL.LSTM_TRAIN_KERNEL = "interpret"
    try:
        def j_loss(x):
            outs, (hF, cF) = JL.lstm_apply(params, x, jnp.asarray(lengths), inference=False)
            return jnp.sum(outs * w_out) + jnp.sum(hF) + jnp.sum(cF * 0.5), outs
        (_, j_outs), j_dx = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x))
    finally:
        JL.LSTM_TRAIN_KERNEL = old

    t_x = _t(x, True)
    outs, (hF, cF) = TL.lstm_apply(lstm, t_x, torch.from_numpy(lengths), inference=False)
    ((outs * _t(w_out)).sum() + hF.sum() + (cF * 0.5).sum()).backward()
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(j_outs), **TOL)
    np.testing.assert_allclose(t_x.grad.numpy(), np.asarray(j_dx), **TOL)


@pytest.mark.parametrize("n", [1, 7, 16, 64, 100, 256, 1300, 100000])
def test_bwd_launch_plan_covers_rows_and_fits(n):
    """The reverse sweep's launch plan at H=512: its chunks and passes span
    all N rows (none beyond N), its shared memory fits in an H100 block's
    232,448 bytes and equals the layout's size, the units divide H, the grid
    is one block per SM at most, and all N rows are staged at once where
    they fit (N=16), else two stages of more than 8 rows each. The step
    operands and carries are in shared memory where that costs the ring no
    chunk (N <= 64 here), else in device memory, so any N has a plan whose
    shared memory does not grow with N."""
    h = 512
    plan = K.lstm_train_bwd_plan(n, h)
    assert 1 <= plan.rows_per_pass <= min(n, K.TILE_ROWS * plan.row_groups, plan.stage_rows)
    assert plan.stage_rows <= n and plan.stages * plan.stage_rows >= min(n, 2)
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == K.bwd_smem_bytes(plan.units, n, h, plan.stages, plan.stage_rows,
                                               plan.resident)
    assert h % plan.units == 0 and plan.blocks == h // plan.units <= K.SMS
    assert plan.stages in (1, 2) and (plan.stages == 2 or plan.stage_rows == n)
    if n <= 16:
        assert plan.stages == 1
    else:  # a ring of two chunks; a pass still spans all four row groups
        assert plan.stages == 2 and plan.row_groups == 4 and plan.stage_rows > 2 * K.TILE_ROWS
    assert plan.resident == (n <= 64)
    if not plan.resident:
        assert plan.smem_bytes == K.lstm_train_bwd_plan(1300, h).smem_bytes


@pytest.mark.parametrize("h, n", [(512, n) for n in (1, 7, 16, 64, 90, 100, 1300, 100000)]
                         + [(1024, n) for n in (25, 32, 1300)])
def test_fwd_launch_plan_fits(h, n):
    """The forward sweep's launch plan: its shared memory fits in an H100
    block's 232,448 bytes and equals the layout's size, the units divide H,
    the grid is one block per SM at most, and all N rows are staged at once
    wherever they fit (at H=512 up to N=97: N=16, N=64 and N=90 here); a
    ring of 16-row slots appears only where the rows do not fit, and its
    shared memory does not grow with N, so any N has a plan. At H=1024 the
    ring has one slot from N=25 on (the kernel then copies a chunk only once
    the one before it is done)."""
    plan = K.lstm_train_fwd_plan(n, h)
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == K.fwd_smem_bytes(plan.units, h, plan.stage_rows)
    assert h % plan.units == 0 and plan.blocks == h // plan.units <= K.SMS
    ring = plan.stage_rows < n
    assert plan.stage_rows <= n
    assert ring != (K.fwd_smem_bytes(plan.units, h, n) <= 232448)
    if ring:
        assert plan.stage_rows % K.PASS_ROWS == 0
        assert 1 <= plan.stage_rows // K.PASS_ROWS <= K.MAX_SLOTS
        assert plan.smem_bytes == K.lstm_train_fwd_plan(100000, h).smem_bytes
    assert ring == (n > 97 if h == 512 else True)
    if h == 1024:
        assert plan.stage_rows == K.PASS_ROWS


def test_reverse_sweep_matches_pallas_bwd_ragged():
    """F=5, N=7: 0-length, one-frame, partial and full rows (a batch that is
    not a multiple of the kernel's 4-row register tile)."""
    f, n = 5, 7
    rng = np.random.RandomState(12)
    lengths = np.array([0, 5, 1, 3, 5, 0, 4])
    mask = (np.arange(f)[:, None] < lengths[None, :]).astype(np.float32)
    w_hh = rng.uniform(-H ** -0.5, H ** -0.5, (H, 4 * H)).astype(np.float32)
    gates = rng.randn(f, n, 4 * H).astype(np.float32)
    c_prev, dh_all, dc_all = (rng.randn(f, n, H).astype(np.float32) for _ in range(3))
    want = JK._pallas_bwd(jnp.asarray(dh_all), jnp.asarray(dc_all), jnp.asarray(gates),
                          jnp.asarray(c_prev), jnp.asarray(mask)[:, :, None], jnp.asarray(w_hh),
                          hidden=H, interpret=True, precision=lax.Precision.HIGHEST)
    got = K.lstm_train_bwd(_t(dh_all), _t(dc_all), _t(gates), _t(c_prev), _t(mask), _t(w_hh))
    for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    for row in (0, 5):  # the empty rows: zero dgates, cotangents summed straight through
        assert torch.equal(got[0][:, row], torch.zeros(f, 4 * H))
        np.testing.assert_allclose(got[2][row].numpy(), dc_all[:, row].sum(0), rtol=1e-6, atol=1e-6)
