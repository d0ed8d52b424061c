"""The port's ``high`` and ``default`` precision modes against the JAX package.

On this CPU XLA ignores ``precision`` on a plain f32 dot, but runs an
explicit bf16 ``dot_general`` with ``preferred_element_type=f32`` exactly,
which is how the Pallas kernels' HIGH branch (``dot3``) is written. So:

* HIGH is held tightly against the JAX kernels in interpret mode, both fed
  the port's projected input at HIGH (both run ``dot3``; they differ only
  in the order of f32 sums), and closer to them than the port at HIGHEST;
* DEFAULT is held against a JAX scan written here with bf16 ``dot_general``
  (tight, but not bit for bit: a 1-ulp difference in h can round an element
  of the next step's bf16 h the other way), and against the JAX functions at
  HIGHEST at bf16's level;
* whole small models at both modes against the JAX model at HIGHEST, and
  the serve, eval and bench CLIs at ``--precision default``/``high``.

Inputs come from numpy seeds at the shapes of
``tests/test_lstm_kernel.py::_high_inputs``. Each test states its tolerance.
"""

import argparse
import gc
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from empose_tpu.nn import layers as JL
from empose_tpu.ops import lstm_kernel as JK

from empose_tpu_torch.device import precision_scope, set_precision
from empose_tpu_torch.nn import layers as TL
from empose_tpu_torch.nn.layers import nn_precision
from empose_tpu_torch.nn.models import fk_precision
from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.ops import precision as P
from empose_tpu_torch.serve import MultiStreamPredictor
from tests.test_torch_checkpoint import sensors  # noqa: F401 (fixture)
from tests.test_torch_serve import BIRNN, CHUNK, S, _feeds, birnn_pair, pair  # noqa: F401

torch.set_num_threads(1)

# HIGH: port vs the JAX kernels on one x0_proj (both dot3; f32 sums in
# another order): about twice the largest reading, 1.64e-7 over 9 seeds,
# and under the port's gap between HIGH and HIGHEST there (5.7e-7 to 6.0e-7).
HIGH_TOL = dict(rtol=0, atol=3e-7)
DEFAULT_EMUL_TOL = dict(rtol=0, atol=2e-5)  # DEFAULT: port vs the bf16 JAX scan
BF16_TOL = dict(rtol=0, atol=5e-3)         # DEFAULT vs JAX at HIGHEST: bf16 level


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _cells(num_layers, seed, i=20, h=128, bidirectional=False):
    params = JL.lstm_init(jax.random.PRNGKey(seed), i, h, num_layers,
                          bidirectional=bidirectional)
    return params["layers"]


def _t_cell(cell):
    return {k: torch.from_numpy(np.array(v)) for k, v in cell.items()}


def _high_inputs(num_layers, seed=5):
    """``tests/test_lstm_kernel.py::_high_inputs``."""
    rng = np.random.RandomState(seed)
    f, n, i, h = 12, 8, 20, 128
    cells = [layer["fwd"] for layer in _cells(num_layers, seed)]
    x = rng.randn(f, n, i).astype(np.float32)
    lengths = np.array([12, 9, 12, 0, 5, 12, 1, 7])
    mask = (np.arange(f)[:, None] < lengths[None, :]).astype(np.float32)
    h0 = (rng.randn(num_layers, n, h) * 0.1).astype(np.float32)
    c0 = (rng.randn(num_layers, n, h) * 0.1).astype(np.float32)
    return cells, x, mask, lengths, h0, c0


def _bidi_inputs(seed=9):
    """``tests/test_lstm_kernel.py::test_high_three_pass_bidi``'s inputs."""
    rng = np.random.RandomState(seed)
    f, n, i, h = 12, 6, 20, 128
    layer = _cells(1, seed, bidirectional=True)[0]
    x = rng.randn(f, n, i).astype(np.float32)
    lengths = np.array([12, 9, 0, 5, 1, 7])
    mask = (np.arange(f)[:, None] < lengths[None, :]).astype(np.float32)
    h0 = (rng.randn(2, n, h) * 0.1).astype(np.float32)
    c0 = (rng.randn(2, n, h) * 0.1).astype(np.float32)
    x_rev = np.asarray(JL._reverse_by_length(jnp.asarray(x), jnp.asarray(lengths)))
    return layer["fwd"], layer["bwd"], x, x_rev, mask, h0, c0


def _assert_close(got, want, tol, msg=""):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# The products


def test_split_bf16_and_dot3_match_jax():
    """split_bf16 equals JAX's bit for bit (round to nearest even, ties
    included); dot3 equals JAX's up to the order of its f32 sums (rtol 1e-6)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(37, 53) * np.exp(rng.randn(37, 53) * 3)).astype(np.float32)
    x[0, :8] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0, -0.0, 1e-30, 3e38, 2 ** -9]
    hi, lo = P.split_bf16(torch.from_numpy(x))
    j_hi, j_lo = JK.split_bf16(jnp.asarray(x))
    assert np.array_equal(hi.view(torch.int16).numpy(), np.asarray(j_hi).view(np.int16))
    assert np.array_equal(lo.view(torch.int16).numpy(), np.asarray(j_lo).view(np.int16))

    a = rng.randn(9, 53).astype(np.float32)
    w = rng.randn(53, 11).astype(np.float32)
    got = P.dot3(torch.from_numpy(a), *P.split_bf16(torch.from_numpy(w)))
    want = JK.dot3(jnp.asarray(a), *JK.split_bf16(jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _jax_product(a, b, mode):
    """The test's own emulation of a product at ``mode``: bf16 dot_general
    with an f32 result (DEFAULT), JAX's dot3 (HIGH)."""
    if mode == "default":
        return lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                               (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    return JK.dot3(a, *JK.split_bf16(b))


@pytest.mark.parametrize("mode", ["default", "high"])
def test_matmul_at_and_its_backward_at_the_mode(mode):
    """matmul_at's value and both gradients are products at the same mode
    (JAX's transpose of a DEFAULT or HIGH dot): equal to the emulation of
    g @ b^T and a^T @ g at the mode up to the order of f32 sums (rtol 1e-5,
    atol 1e-6), where autograd through casts would give f32 gradients."""
    rng = np.random.RandomState(3)
    a = rng.randn(2, 7, 40).astype(np.float32)
    b = rng.randn(40, 24).astype(np.float32)
    g = rng.randn(2, 7, 24).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = P.matmul_at(ta, tb, mode)
    (y * torch.from_numpy(g)).sum().backward()
    a2, g2 = jnp.asarray(a.reshape(14, 40)), jnp.asarray(g.reshape(14, 24))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy().reshape(14, 24),
                               np.asarray(_jax_product(a2, jnp.asarray(b), mode)), **tol)
    np.testing.assert_allclose(ta.grad.numpy().reshape(14, 40),
                               np.asarray(_jax_product(g2, jnp.asarray(b).T, mode)), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(_jax_product(a2.T, g2, mode)), **tol)
    # And not the f32 gradient: the modes round (HIGH to about 2^-16).
    f32 = torch.from_numpy(g.reshape(14, 24)) @ torch.from_numpy(b).t()
    assert (ta.grad.reshape(14, 40) - f32).abs().max() > (1e-4 if mode == "default" else 0)
    # HIGHEST is the plain product, its gradient autograd's.
    tc = torch.from_numpy(a).requires_grad_()
    (P.matmul_at(tc, tb, "highest") * torch.from_numpy(g)).sum().backward()
    assert torch.equal(tc.grad, torch.from_numpy(g) @ torch.from_numpy(b).t())
    with pytest.raises(ValueError, match="unknown precision"):
        P.matmul_at(ta, tb, "bf16")


def test_weight_parts_made_once_per_weight():
    """A weight's bf16 form (``ops/precision.derived``) is made once: the
    same tensors on a later call, through a new view of the same weight
    too; made anew after an in-place update; dropped when the weight is
    freed; made per call where autograd tracks the weight. The stacked
    kernel weights of ``stack_operands`` are kept at high and default, not
    at highest."""
    w = torch.randn(8, 6)
    first = {mode: P.weight_parts(w.t(), mode) for mode in ("default", "high")}
    for mode, parts in first.items():
        again = P.weight_parts(w.t(), mode)
        assert all(a is b for a, b in zip(again, parts))
    n_kept = len(P._DERIVED)
    with torch.no_grad():
        w.add_(1.0)
    hi, lo = P.weight_parts(w.t(), "high")
    assert hi is not first["high"][0] and torch.equal(hi, P.split_bf16(w.t())[0])
    assert torch.equal(lo, P.split_bf16(w.t())[1])
    del w, first, hi, lo
    gc.collect()
    assert len(P._DERIVED) == n_kept - 2
    p = torch.nn.Parameter(torch.randn(4, 4))
    assert P.weight_parts(p, "default")[0] is not P.weight_parts(p, "default")[0]
    with torch.no_grad():
        assert P.weight_parts(p, "default")[0] is P.weight_parts(p, "default")[0]

    cells, x, *_ = _high_inputs(2, seed=7)
    t_cells, tx = [_t_cell(c) for c in cells], torch.from_numpy(x)
    for mode, kept in (("default", True), ("high", True), ("highest", False)):
        a, b = K.stack_operands(t_cells, tx, mode), K.stack_operands(t_cells, tx, mode)
        assert (a[1] is b[1] and a[2] is b[2]) == kept
        assert torch.equal(a[1], torch.stack([c["w_hh"] for c in t_cells]))


# ---------------------------------------------------------------------------
# The LSTM kernels' plain versions at HIGH, against the JAX kernels on the
# same projected input (both sides get the port's x0_proj at HIGH)


def _j(t):
    return jnp.asarray(t.numpy())


def _max_diff(got, want):
    return max(float(np.abs(g.numpy() - np.asarray(w)).max()) for g, w in zip(got, want))


def _stack_at_high(cells, x, mask, h0, c0):
    """The port's stack operands at HIGH and (mask, h0, c0) as tensors."""
    ops = K.stack_operands([_t_cell(c) for c in cells], torch.from_numpy(x), "high")
    return ops, _t(mask, h0, c0)


def _held_at_high(got, want, highest):
    """``got`` (the port at HIGH) within HIGH_TOL of ``want`` (JAX's kernel
    at HIGH), and closer to it than the port at HIGHEST is."""
    _assert_close(got, want, HIGH_TOL)
    assert _max_diff(got, want) < _max_diff(highest, want)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_stack_high_matches_jax_kernel(num_layers):
    cells, x, mask, _, h0, c0 = _high_inputs(num_layers)
    (xp, w_hh, w_up, b_up), (tm, th0, tc0) = _stack_at_high(cells, x, mask, h0, c0)
    want = JK._pallas_forward(
        _j(xp), jnp.asarray(mask)[:, :, None], _j(w_hh), None if w_up is None else _j(w_up),
        None if b_up is None else _j(b_up)[:, None], jnp.asarray(h0), jnp.asarray(c0),
        num_layers=num_layers, hidden=w_hh.shape[1], interpret=True,
        precision=lax.Precision.HIGH)
    args = (xp, tm, w_hh, w_up, b_up, th0, tc0)
    _held_at_high(K.lstm_stack_plain(*args, "high"), want, K.lstm_stack_plain(*args, "highest"))


def test_plain_wavefront_high_matches_jax_kernel():
    cells, x, mask, _, h0, c0 = _high_inputs(2, seed=6)
    (xp, w_hh, w_up, b_up), (tm, th0, tc0) = _stack_at_high(cells, x, mask, h0, c0)
    mc = jnp.asarray(mask)[:, :, None]
    zero = jnp.zeros_like(mc[:1])
    m_all = jnp.stack([jnp.concatenate([zero] * l + [mc] + [zero] * (1 - l)) for l in range(2)],
                      axis=1)
    w_cat = jnp.concatenate([_j(w_up[0]), _j(w_hh[1])])[None]
    want = JK._pallas_wavefront(_j(xp), m_all, _j(w_hh[0]), w_cat, _j(b_up)[:, None],
                                jnp.asarray(h0), jnp.asarray(c0), num_layers=2,
                                hidden=w_hh.shape[1], interpret=True,
                                precision=lax.Precision.HIGH)[:3]
    args = (xp, tm, w_hh, w_up, b_up, th0, tc0)
    _held_at_high(K.lstm_stack_wavefront_plain(*args, "high"), want,
                  K.lstm_stack_wavefront_plain(*args, "highest"))


def test_plain_bidi_high_matches_jax_kernel():
    cf, cb, x, x_rev, mask, h0, c0 = _bidi_inputs()
    xp = torch.stack([P.matmul_at(torch.from_numpy(np.array(xs)), c["w_ih"], "high")
                      + c["b_ih"] + c["b_hh"]
                      for c, xs in ((_t_cell(cf), x), (_t_cell(cb), x_rev))], dim=1)
    w_hh2 = torch.stack([_t_cell(cf)["w_hh"], _t_cell(cb)["w_hh"]])
    want = JK._pallas_bidi(_j(xp), jnp.asarray(mask)[:, :, None], _j(w_hh2), jnp.asarray(h0),
                           jnp.asarray(c0), hidden=w_hh2.shape[1], interpret=True,
                           precision=lax.Precision.HIGH)
    args = (xp, *_t(mask), w_hh2, *_t(h0, c0))
    _held_at_high(K.lstm_bidi_plain(*args, "high"), want, K.lstm_bidi_plain(*args, "highest"))


# ---------------------------------------------------------------------------
# DEFAULT: against a JAX scan with bf16 dot_general, and against HIGHEST


def _bf16_dot(a, w):
    return lax.dot_general(a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                           (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _cell_scan_bf16(cell, x, mask, h0, c0):
    """The masked LSTM scan with every product in bf16 inputs and f32 sums
    (the layer-0 projection too, as the port makes it at DEFAULT)."""
    hd = cell["w_hh"].shape[0]
    xp = _bf16_dot(x, cell["w_ih"]) + cell["b_ih"] + cell["b_hh"]

    def step(carry, inp):
        hp, cp = carry
        xpt, m = inp
        gates = xpt + _bf16_dot(hp, cell["w_hh"])
        i = jax.nn.sigmoid(gates[:, :hd])
        fo = jax.nn.sigmoid(gates[:, hd:2 * hd])
        g = jnp.tanh(gates[:, 2 * hd:3 * hd])
        o = jax.nn.sigmoid(gates[:, 3 * hd:])
        cn = fo * cp + i * g
        hn = o * jnp.tanh(cn)
        m1 = m[:, None]
        return (jnp.where(m1 > 0, hn, hp), jnp.where(m1 > 0, cn, cp)), hn * m1

    (hF, cF), outs = lax.scan(step, (h0, c0), (xp, mask))
    return outs, hF, cF


def _stack_scan_bf16(cells, x, mask, h0s, c0s):
    xt, hs, cs = jnp.asarray(x), [], []
    for l, cell in enumerate(cells):
        xt, hF, cF = _cell_scan_bf16(cell, xt, jnp.asarray(mask), jnp.asarray(h0s[l]),
                                     jnp.asarray(c0s[l]))
        hs.append(hF)
        cs.append(cF)
    return xt, jnp.stack(hs), jnp.stack(cs)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_stack_default(num_layers):
    cells, x, mask, _, h0, c0 = _high_inputs(num_layers)
    t_cells = [_t_cell(c) for c in cells]
    out, (hF, cF) = K.lstm_stack(t_cells, *_t(x, mask, h0, c0), K.lstm_stack_plain, "default")
    _assert_close((out, hF, cF), _stack_scan_bf16(cells, x, mask, h0, c0), DEFAULT_EMUL_TOL)
    j_out, (j_h, j_c) = JK.lstm_stack_pallas(cells, jnp.asarray(x), jnp.asarray(mask),
                                             jnp.asarray(h0), jnp.asarray(c0),
                                             precision=lax.Precision.HIGHEST, interpret=True)
    _assert_close((out, hF, cF), (j_out, j_h, j_c), BF16_TOL)


def test_plain_wavefront_default():
    cells, x, mask, _, h0, c0 = _high_inputs(2, seed=6)
    out, (hF, cF) = K.lstm_stack_wavefront([_t_cell(c) for c in cells], *_t(x, mask, h0, c0),
                                           K.lstm_stack_wavefront_plain, "default")
    _assert_close((out, hF, cF), _stack_scan_bf16(cells, x, mask, h0, c0), DEFAULT_EMUL_TOL)
    j_out, (j_h, j_c) = JK.lstm_stack_pallas_wavefront(
        cells, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0), jnp.asarray(c0),
        precision=lax.Precision.HIGHEST, interpret=True)
    _assert_close((out, hF, cF), (j_out, j_h, j_c), BF16_TOL)


def test_plain_bidi_default():
    cf, cb, x, x_rev, mask, h0, c0 = _bidi_inputs()
    out, (hF, cF) = K.lstm_bidi_layer(_t_cell(cf), _t_cell(cb), *_t(x, x_rev, mask, h0, c0),
                                      K.lstm_bidi_plain, "default")
    rf = _cell_scan_bf16(cf, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0[0]),
                         jnp.asarray(c0[0]))
    rb = _cell_scan_bf16(cb, jnp.asarray(x_rev), jnp.asarray(mask), jnp.asarray(h0[1]),
                         jnp.asarray(c0[1]))
    _assert_close((out[:, 0], out[:, 1], hF, cF),
                  (rf[0], rb[0], jnp.stack([rf[1], rb[1]]), jnp.stack([rf[2], rb[2]])),
                  DEFAULT_EMUL_TOL)
    j_out, (j_h, j_c) = JK.lstm_bidi_layer_pallas(
        cf, cb, *(jnp.asarray(a) for a in (x, x_rev, mask, h0, c0)),
        precision=lax.Precision.HIGHEST, interpret=True)
    _assert_close((out, hF, cF), (j_out, j_h, j_c), BF16_TOL)


def test_fused_wrappers_on_the_cpu_take_the_mode():
    """On CPU tensors the wrappers run their plain versions at the mode,
    bit for bit, and the fused stack equals the per-layer route's results."""
    cells, x, mask, _, h0, c0 = _high_inputs(2, seed=7)
    t_cells = [_t_cell(c) for c in cells]
    ops = K.stack_operands(t_cells, torch.from_numpy(x), "default")
    args = (ops[0], torch.from_numpy(mask), ops[1], ops[2], ops[3], *_t(h0, c0))
    for fused, plain in ((K.lstm_stack_fused, K.lstm_stack_plain),
                         (K.lstm_stack_wavefront_fused, K.lstm_stack_wavefront_plain)):
        for mode in ("high", "default"):
            for a, b in zip(fused(*args, mode), plain(*args, mode)):
                assert torch.equal(a, b)
    cf, cb, x, x_rev, mask, h0, c0 = _bidi_inputs()
    a = K.lstm_bidi_layer(_t_cell(cf), _t_cell(cb), *_t(x, x_rev, mask, h0, c0),
                          precision="high")
    b = K.lstm_bidi_layer(_t_cell(cf), _t_cell(cb), *_t(x, x_rev, mask, h0, c0),
                          K.lstm_bidi_plain, "high")
    assert all(torch.equal(u, v) for u, v in zip((a[0],) + a[1], (b[0],) + b[1]))


# ---------------------------------------------------------------------------
# Launch plans: the mode's bytes per element


def test_plans_read_the_mode_bytes():
    """At DEFAULT the resident columns are bf16 (half of HIGHEST's bytes),
    at HIGH the hi/lo pair (HIGHEST's bytes); in both orders a ring of one
    state's 16-row chunks in k-step tiles (16 x Kp bf16 a part a slot)
    streams beside the ring's sync block and two buffers of 8 warps' 16 x
    4U partial tiles."""
    for layers, h, units in ((2, 512, 4), (1, 1024, 8), (3, 64, 4), (2, 260, 4)):
        kp = -(-h // 16) * 16
        cols32 = (2 * layers - 1) * 4 * units * h * 4
        rest = lambda stages, parts: stages * parts * 16 * kp * 2 + 144 + 2 * 8 * 16 * 4 * units * 4
        for stages in (1, 3):
            assert K.stack_ring_smem_bytes(units, h, layers, stages, "default") == \
                cols32 * kp // h // 2 + rest(stages, 1)
            assert K.stack_ring_smem_bytes(units, h, layers, stages, "high") == \
                cols32 * kp // h + rest(stages, 2)
    # 2x512, both orders (two items a chunk at two layers): two teams of 4
    # warps beside a ring of 8 slots (DEFAULT) or 3 (HIGH). One layer of
    # 1024 runs U=8 at every mode; 2x1024 fits one launch at no mode.
    for mode, ring in (("default", (8, 196752)), ("high", (3, 213136))):
        plan = K.lstm_stack_plan(2, 64, 512, wavefront=True, precision=mode)
        assert plan == K.StackPlan(4, 128, 2, 16 * ring[0], 2, ring[1])
        assert K.lstm_stack_plan(2, 64, 512, precision=mode) == K.StackPlan(
            4, 128, 2, 16 * ring[0], 2, ring[1])
        assert K.lstm_stack_plan(2, 1, 512, precision=mode).teams == 1
        assert K.lstm_stack_plan(1, 64, 1024, precision=mode).units == 8
        assert K.lstm_stack_plan(2, 1300, 512, wavefront=True, precision=mode).stage_rows == \
            16 * ring[0]
        assert K.lstm_stack_plan(2, 1300, 512, precision=mode).stage_rows == 16 * ring[0]
        assert K.lstm_stack_fits(2, 512, precision=mode)
        assert not K.lstm_stack_fits(2, 1024, precision=mode)
        with pytest.raises(ValueError, match="does not fit"):
            K.lstm_stack_plan(2, 64, 1024, precision=mode)
    assert K.lstm_stack_plan(1, 64, 1024, precision="default").smem_bytes == 229520
    assert K.lstm_stack_plan(1, 64, 1024, precision="high").smem_bytes == 229520
    # The bidirectional layer: the same grid, a ring of 16-row bf16 chunks
    # (all 4 of N=64 at H=512; at H=1024 2 at default, 1 at high).
    for mode, st512, smem512, st1024, smem1024 in (("default", 4, 131216, 2, 163984),
                                                   ("high", 4, 229520, 1, 229520)):
        p512, p1024 = K.lstm_bidi_plan(64, 512, precision=mode), K.lstm_bidi_plan(
            32, 1024, precision=mode)
        assert p512 == K.BidiPlan(8, 128, 2, 1, 16 * st512, st512, smem512)
        assert p1024 == K.BidiPlan(8, 128, 1, 2, 16 * st1024, st1024, smem1024)
        assert K.lstm_bidi_plan(17, 516, precision=mode).units == 4
    # The columns and the ring double; the two buffers of partials and the
    # ring's sync block (mbarriers and the count of chunks issued) do not.
    assert K.bidi_smem_bytes(8, 512, 16, "default") * 2 - K.bidi_smem_bytes(8, 512, 16, "high") \
        == 2 * 8 * 16 * 4 * 8 * 4 + 144
    with pytest.raises(ValueError, match="unknown precision"):
        K.lstm_stack_plan(2, 64, 512, precision="bf16")


# ---------------------------------------------------------------------------
# Whole models and the CLIs


def _serve(model, feeds, offsets, precision):
    port = MultiStreamPredictor(model, S, CHUNK)
    for s in range(S):
        port.set_offsets(s, *offsets[s])
    outs = []
    with precision_scope(precision):
        for r in range(2):
            for s in range(S):
                port.push(s, feeds[s][0][r * CHUNK:(r + 1) * CHUNK],
                          feeds[s][1][r * CHUNK:(r + 1) * CHUNK])
            outs.append(port.step())
    return outs


def _max_step_diff(a, b):
    return max(float(np.abs(x[s][k] - y[s][k]).max()) for x, y in zip(a, b) for s in x
               for k in x[s])


@pytest.mark.parametrize("model", ["lgd", "birnn"])
def test_models_at_each_mode_against_jax_highest(pair, birnn_pair, model):
    """LGD-RNN (stack, LGD's differentiated FK) and BiRNN (bidi layer) served
    at ``high`` within 1e-3 and at ``default`` within 5e-2 (radians; bf16
    rounding through the LGD loop) of the JAX model at HIGHEST; ``default``
    moves them, ``high`` stays near ``highest``; ``precision_scope`` leaves
    the knobs as it found them."""
    from empose_tpu.serve import MultiStreamPredictor as JMulti
    (j_model, params, state), t_model = pair if model == "lgd" else birnn_pair
    feeds, offsets = _feeds(4)
    ref = JMulti(j_model, params, state, S, CHUNK)
    for s in range(S):
        ref.set_offsets(s, *offsets[s])
    want = []
    for r in range(2):
        for s in range(S):
            ref.push(s, feeds[s][0][r * CHUNK:(r + 1) * CHUNK],
                     feeds[s][1][r * CHUNK:(r + 1) * CHUNK])
        want.append(ref.step())
    got = {mode: _serve(t_model, feeds, offsets, mode) for mode in ("highest", "high", "default")}
    assert nn_precision() == "highest" and fk_precision() == "highest"
    diffs = {mode: _max_step_diff(g, want) for mode, g in got.items()}
    assert diffs["highest"] <= 1e-4, diffs
    assert diffs["high"] <= 1e-3, diffs
    assert 1e-6 < diffs["default"] <= 5e-2, diffs


def test_kinematics_knob_governs_markers_and_joints_only(monkeypatch):
    """markers_and_joints reads the kinematics knob; SensorSMPL.joints stays
    f32 bit for bit at every mode. At ``high`` every output is within 2e-3
    of HIGHEST (the sensor frames, made from small triangles, amplify the
    vertices' 1e-5 m); at ``default`` the bf16 blend of metre-scale skinning
    translations moves the marker positions by millimetres (within 1e-2 m)
    and the joints by 1e-4 m (within 1e-3 m), as JAX's lane-major FK at
    DEFAULT does."""
    from empose_tpu_torch.bodymodel.synthetic import make_synthetic_smplh
    from empose_tpu_torch.bodymodel.smplh import load_smplh
    from empose_tpu_torch.nn.models import SensorSMPL
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.npz")
        np.savez(path, **make_synthetic_smplh(seed=0))
        sensor = SensorSMPL(load_smplh(path))
    rng = np.random.RandomState(0)
    poses = torch.from_numpy((rng.randn(5, 66) * 0.4).astype(np.float32))
    shapes = torch.from_numpy((rng.randn(5, 10) * 0.8).astype(np.float32))
    out = {}
    try:
        for mode in ("highest", "high", "default"):
            set_precision(mode)
            out[mode] = (sensor.markers_and_joints(poses, shapes), sensor.joints(poses, shapes))
    finally:
        set_precision("highest")
    for mode in ("high", "default"):
        assert torch.equal(out[mode][1], out["highest"][1])
    for a, b in zip(out["high"][0], out["highest"][0]):
        assert (a - b).abs().max() <= 2e-3
    (pos, _, _, joints), (pos0, _, _, joints0) = out["default"][0], out["highest"][0]
    assert 0 < (pos - pos0).abs().max() <= 1e-2
    assert (joints - joints0).abs().max() <= 1e-3


def test_serve_cli_precision_flag(pair, assets_env, tmp_path, monkeypatch, capsys):
    """``--precision default``: the CLI binds both knobs (left bound, as the
    JAX CLI leaves them; restored here), and serves within 5e-2 of
    ``highest``; ``high`` within 1e-3."""
    from empose_tpu.checkpoint.torch_writer import save_torch_checkpoint
    from empose_tpu_torch.serve import main as serve_main
    from tests.test_torch_serve import CFG
    from empose_tpu.config import Configuration as JConfiguration
    (_, params, state), _ = pair
    exp = tmp_path / "720001-LGD-test"
    exp.mkdir()
    cfg = JConfiguration.from_dict(CFG)
    cfg.to_json(str(exp / "config.json"))
    save_torch_checkpoint(str(exp / "model.pth"), params, state, cfg)
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    rng = np.random.RandomState(11)
    lines = [json.dumps({"marker_pos": (rng.randn(36) * 0.3).astype(float).tolist(),
                         "marker_ori": (rng.randn(108) * 0.3).astype(float).tolist()})
             for _ in range(4)]
    outs = {}
    try:
        for prec in ("highest", "high", "default"):
            monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
            serve_main(argparse.Namespace(model_id="720001", chunk=4, streams=1, precision=prec,
                                          device="cpu"))
            outs[prec] = np.array([json.loads(l)["pose_body"] for l in
                                   capsys.readouterr().out.strip().splitlines()
                                   if l.startswith("{")])
            assert nn_precision() == prec and fk_precision() == prec
    finally:
        set_precision("highest")
    assert outs["default"].shape == outs["highest"].shape == (4, 63)
    assert np.abs(outs["high"] - outs["highest"]).max() <= 1e-3
    assert 0 < np.abs(outs["default"] - outs["highest"]).max() <= 5e-2


def test_eval_cli_precision_default(assets_env, tmp_path, monkeypatch, capsys):
    """``python -m empose_tpu_torch.eval --precision default`` on the CPU: every
    pass runs with both knobs at ``default`` (restored after), and its rows
    stay within 1e-2 relative (atol 0.5 in the rows' mm and degrees) of the
    ``highest`` rows, while moving them."""
    from empose_tpu_torch.eval import cli, harness
    from tests.test_torch_eval_cli import variant_config, write_experiment
    exp_dir = str(tmp_path / "experiments")
    import os
    os.makedirs(exp_dir)
    monkeypatch.setenv("EM_EXPERIMENTS", exp_dir)
    write_experiment(exp_dir, "9310", variant_config("rnn", 6), seed=3)
    seen = []
    run = harness.evaluate_real_sequences
    monkeypatch.setattr(cli, "evaluate_real_sequences",
                        lambda *a, **k: seen.append((nn_precision(), fk_precision()))
                        or run(*a, **k))
    base, _ = cli.main(["--model_id", "9310", "--device", "cpu"])
    for flags in ([], ["--serial"], ["--host_metrics"]):
        rows, _ = cli.main(["--model_id", "9310", "--device", "cpu", "--precision", "default"]
                           + flags)
        assert nn_precision() == "highest" and fk_precision() == "highest"
        assert [r[0] for r in rows] == [r[0] for r in base]
        got, want = np.array([r[1:] for r in rows]), np.array([r[1:] for r in base])
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=0.5)
        assert np.abs(got - want).max() > 0
    assert seen == [("highest", "highest")] + [("default", "default")] * 3


def test_bench_tool_runs_each_mode_on_the_cpu(capsys):
    from empose_tpu_torch.tools import bench_lstm_kernels
    for mode in ("high", "default"):
        rows = bench_lstm_kernels.main(["--batch", "2", "--window", "3", "--hidden", "16",
                                        "--input", "6", "--iters", "1", "--repeats", "1",
                                        "--device", "cpu", "--precision", mode])
        assert [name for _, name, *_ in rows] == ["scan", "kernel", "wavefront"]
        assert f"precision={mode}" in capsys.readouterr().out
        assert nn_precision() == "highest"


@pytest.mark.parametrize("mode", ["high", "default"])
def test_lstm_training_runs_at_each_mode(mode):
    """lstm_apply in training mode runs at the NN knob's mode (the training
    pair's HIGH and DEFAULT branches; ``tests/test_torch_train_precision.py``
    holds them against JAX): differentiable, moved from ``highest``, and
    the knob left as it was."""
    lstm = TL.LSTM(4, 8, 1)
    TL.init_parameters(lstm, torch.Generator().manual_seed(0))
    x, lengths = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(1)), \
        torch.tensor([3, 2])
    base, _ = TL.lstm_apply(lstm, x, lengths, inference=False)
    with precision_scope(mode):
        out, _ = TL.lstm_apply(lstm, x, lengths, inference=False)
    assert nn_precision() == "highest"
    out.sum().backward()
    assert out.shape == (2, 3, 8) and 0 < float((out - base).abs().max()) < 1e-2
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in lstm.parameters())
