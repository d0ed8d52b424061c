"""Training at the ``high`` and ``default`` precision modes against the JAX package.

On this CPU XLA ignores ``precision`` on a plain f32 dot, but runs an
explicit bf16 ``dot_general`` with ``preferred_element_type=f32`` exactly,
which is how the JAX training pair's HIGH branch (``dot3``) is written. So:

* the port's plain training pair at HIGH is held tightly against
  ``_pallas_fwd``/``_pallas_bwd(precision=HIGH, interpret=True)``, both fed
  the same ``x_proj``, gates and cotangents and JAX's ``split_bf16`` pair of
  W_hh, and closer to them than the port at HIGHEST;
* at DEFAULT the Pallas interpret run is no reference (its DEFAULT dot runs
  in f32 here), so the pair and its gradients are held against a JAX scan
  written here whose every product is a bf16 ``dot_general`` with an f32
  result, forward and backward (``_bf16_mm``'s custom VJP: JAX's transpose
  of a DEFAULT dot on the TPU), and against the JAX pair at HIGHEST at
  bf16's level;
* ``lstm_cell_train`` and ``lstm_apply(inference=False)``, one and two
  directions, the weight form made once per step, whole train steps of tiny
  LGD-RNN and BiRNN models at ``high``, ``default`` and ``--bf16`` against
  ``jax.grad`` with the JAX trainer's knobs at the mode, and the CLI at
  ``--bf16`` (resumed bit for bit; ``--bf16 --matmul_precision high``
  refused).

Inputs come from numpy seeds. Each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from empose_tpu.nn import layers as JL
from empose_tpu.nn.models import create_model as j_create_model
from empose_tpu.ops import lstm_kernel as JK
from empose_tpu.ops import lstm_train_kernel as JT
from empose_tpu.ops.fk_lanes import set_fk_precision as j_set_fk_precision

from empose_tpu_torch.checkpoint.from_jax import grads_from_jax, state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import precision_scope
from empose_tpu_torch.nn import layers as TL
from empose_tpu_torch.nn.layers import nn_precision
from empose_tpu_torch.nn.models import create_model, fk_precision
from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.ops import precision as P
from empose_tpu_torch.train import loop as TLoop
from empose_tpu_torch.train.cli import main
from tests.test_torch_checkpoint import _jax_params, sensors  # noqa: F401 (fixture)
from tests.test_torch_train_loop import TINY_BIRNN, _losses
from tests.test_torch_train_step import RNN_COMMON, TRAIN_CFG, _batch, _pad_scale

torch.set_num_threads(1)

F, N, H = 12, 8, 64
HIGH = lax.Precision.HIGH
# HIGH, plain pair vs the JAX Pallas pair in interpret mode (both dot3 on
# the same operands; f32 sums in another order; gates up to about 6 in
# magnitude): about twice the largest reading over 8 seeds (forward
# 7.26e-7, reverse 1.49e-6), and under the smallest gap between the port at
# HIGHEST and the JAX pair at HIGH there (3.87e-6, 6.57e-6).
FWD_HIGH_TOL = dict(rtol=0, atol=1.5e-6)
BWD_HIGH_TOL = dict(rtol=0, atol=3e-6)
# DEFAULT, the port vs the bf16 JAX scan: the same bf16 products summed in
# another order; a 1-ulp difference can round an element of the next
# step's bf16 operand the other way. Outputs: 2e-5, about 80x the largest
# reading over 8 seeds (2.4e-7). Gradients: a sum over F N products moves
# by up to 2^-8 of one term where one element of dgates or h rounds the
# other way, so atol 2e-4 (1 + max |gradient|) per tensor (readings up to
# 1.03e-4 over 8 seeds, gradients up to 12).
DEFAULT_EMUL_TOL = dict(rtol=0, atol=2e-5)
DEFAULT_GRAD_SCALE = 2e-4
BF16_TOL = dict(rtol=0, atol=5e-3)  # DEFAULT vs JAX at HIGHEST: bf16 level
MODES = ("high", "default")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(np.asarray(a))) for a in arrays)


def _close(got, want, tol, msg=""):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach() if torch.is_tensor(g) else g),
                                   np.asarray(w), **tol, err_msg=msg)


def _max_diff(got, want):
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) for g, w in zip(got, want))


def _pair_inputs(seed=0):
    """x_proj (F, N, 4H), mask with 0-length, partial and full rows, W_hh,
    h0, c0, and the cotangents dh_all, dc_all."""
    rng = np.random.RandomState(seed)
    lengths = np.array([F, 9, F, 0, 5, F, 1, 7])
    mask = (np.arange(F)[:, None] < lengths[None, :]).astype(np.float32)
    x_proj = (rng.randn(F, N, 4 * H) * 0.5).astype(np.float32)
    w_hh = ((rng.rand(H, 4 * H) * 2 - 1) * H ** -0.5).astype(np.float32)
    h0, c0 = ((rng.randn(2, N, H) * 0.5).astype(np.float32))
    dh, dc = rng.randn(2, F, N, H).astype(np.float32)
    return x_proj, mask, w_hh, h0, c0, dh, dc


# ---------------------------------------------------------------------------
# The plain pair at HIGH against the JAX Pallas pair at HIGH


def test_plain_forward_sweep_high_matches_jax_kernel():
    x_proj, mask, w_hh, h0, c0, _, _ = _pair_inputs(1)
    whi, wlo = JK.split_bf16(jnp.asarray(w_hh))
    want = JT._pallas_fwd(jnp.asarray(x_proj), jnp.asarray(mask)[:, :, None], whi, wlo,
                          jnp.asarray(h0), jnp.asarray(c0), hidden=H, interpret=True,
                          precision=HIGH)
    args = _t(x_proj, mask, w_hh, h0, c0)
    got = TK.lstm_train_fwd_plain(*args, True, "high")
    _close(got, want, FWD_HIGH_TOL)
    assert _max_diff(got, want) < _max_diff(TK.lstm_train_fwd_plain(*args, True, "highest"),
                                            want)
    # The wrapper on CPU tensors is the plain version; W_hh's form handed in
    # by the caller (as LSTMCore does) gives the same bits.
    parts = P.split_bf16(args[2])
    again = TK.lstm_train_fwd(*args, True, "high", parts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_plain_reverse_sweep_high_matches_jax_kernel():
    """Fed JAX's gates and c_prev, the port's reverse sweep at HIGH gives
    the JAX kernel's dgates, dh0 and dc0 (BWD_HIGH_TOL), closer than at
    HIGHEST."""
    x_proj, mask, w_hh, h0, c0, dh, dc = _pair_inputs(2)
    whi, wlo = JK.split_bf16(jnp.asarray(w_hh))
    m3 = jnp.asarray(mask)[:, :, None]
    gates, _, c_all = JT._pallas_fwd(jnp.asarray(x_proj), m3, whi, wlo, jnp.asarray(h0),
                                     jnp.asarray(c0), hidden=H, interpret=True, precision=HIGH)
    c_prev = jnp.concatenate([jnp.asarray(c0)[None], c_all[:-1]])
    want = JT._pallas_bwd(jnp.asarray(dh), jnp.asarray(dc), gates, c_prev, m3, whi, wlo,
                          hidden=H, interpret=True, precision=HIGH)
    args = _t(dh, dc, gates, c_prev, mask, w_hh)
    got = TK.lstm_train_bwd_plain(*args, "high")
    _close(got, want, BWD_HIGH_TOL)
    assert _max_diff(got, want) < _max_diff(TK.lstm_train_bwd_plain(*args, "highest"), want)
    assert (got[0][:, 3] == 0).all()  # the 0-length row: zero dgates


def _reverse_sweep_split_once(dh_all, dc_all, gates, c_prev, mask, w_hh, mode):
    """The reverse sweep with the data flow of the kernel's mode body: each
    step's dgates formed in f32 (``_make_bwd_kernel``'s formulas) and split
    once into bf16 (hi, lo) by ``ops/precision.split_bf16``, as phase (A)
    writes the exchange buffer, then multiplied with W_hh^T's bf16 form:
    ``hi@Wh + lo@Wh + hi@Wl`` at high (dot3's order), ``hi@Wh`` at default."""
    w_t = [w.t() for w in P.bf16_parts(w_hh, mode)]
    dh, dc = torch.zeros_like(dh_all[0]), torch.zeros_like(dc_all[0])
    dgates = torch.empty_like(gates)
    for t in range(gates.shape[0] - 1, -1, -1):
        m = mask[t][:, None]
        Dh, Dc = dh + dh_all[t], dc + dc_all[t]
        gi, gf, gg, go = gates[t].chunk(4, dim=-1)
        i, f, o, g = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go), torch.tanh(gg)
        cp = c_prev[t]
        tc = torch.tanh(f * cp + i * g)
        dh_new = Dh * m
        dc_new = Dc * m + dh_new * o * (1.0 - tc * tc)
        dgates[t] = torch.cat([dc_new * g * i * (1.0 - i), dc_new * cp * f * (1.0 - f),
                               dc_new * i * (1.0 - g * g), dh_new * tc * o * (1.0 - o)], dim=-1)
        hi, lo = P.split_bf16(dgates[t])
        back = P.mm_bf16(hi, w_t[0])
        if mode == "high":
            back = back + P.mm_bf16(lo, w_t[0]) + P.mm_bf16(hi, w_t[1])
        dh = back + Dh * (1.0 - m)
        dc = dc_new * f + Dc * (1.0 - m)
    return dgates, dh, dc


def _bwd_scan_bf16(dh_all, dc_all, gates, c_prev, mask, w_hh):
    """``_make_bwd_kernel``'s reverse sweep as a JAX scan with its product
    at DEFAULT (``_bf16_mm``): (dgates, dh0, dc0)."""
    def step(carry, inp):
        dh, dc = carry
        dh_t, dc_t, g4, cp, m = inp
        m1 = m[:, None]
        Dh, Dc = dh + dh_t, dc + dc_t
        i, f = jax.nn.sigmoid(g4[:, :H]), jax.nn.sigmoid(g4[:, H:2 * H])
        g, o = jnp.tanh(g4[:, 2 * H:3 * H]), jax.nn.sigmoid(g4[:, 3 * H:])
        tc = jnp.tanh(f * cp + i * g)
        dh_new = Dh * m1
        dc_new = Dc * m1 + dh_new * o * (1.0 - tc * tc)
        dg = jnp.concatenate([dc_new * g * i * (1.0 - i), dc_new * cp * f * (1.0 - f),
                              dc_new * i * (1.0 - g * g), dh_new * tc * o * (1.0 - o)], axis=-1)
        back = _bf16_mm(dg, w_hh.T)
        return (back + Dh * (1.0 - m1), dc_new * f + Dc * (1.0 - m1)), dg

    zeros = jnp.zeros_like(dh_all[0])
    (dh0, dc0), dgates = lax.scan(step, (zeros, zeros), (dh_all, dc_all, gates, c_prev, mask),
                                  reverse=True)
    return dgates, dh0, dc0


@pytest.mark.parametrize("mode", MODES)
def test_plain_reverse_sweep_is_the_split_once_data_flow(mode):
    """The plain reverse sweep at each mode equals, bit for bit, the mode
    body's data flow (dgates split once, then multiplied), and lies within
    its tolerance of the JAX reverse sweep at the mode: at HIGH the JAX
    ``_pallas_bwd`` in interpret mode (BWD_HIGH_TOL, closer than the port
    at HIGHEST); at DEFAULT, whose Pallas dot runs in f32 on this CPU, the
    kernel's formulas as a JAX scan with bf16 products (DEFAULT_EMUL_TOL),
    both fed JAX's gates and c_prev."""
    x_proj, mask, w_hh, h0, c0, dh, dc = _pair_inputs(4)
    m3 = jnp.asarray(mask)[:, :, None]
    if mode == "high":
        whi, wlo = JK.split_bf16(jnp.asarray(w_hh))
        gates, _, c_all = JT._pallas_fwd(jnp.asarray(x_proj), m3, whi, wlo, jnp.asarray(h0),
                                         jnp.asarray(c0), hidden=H, interpret=True,
                                         precision=HIGH)
    else:
        gates, _, c_all = _core_scan_bf16(*(jnp.asarray(a) for a in (x_proj, mask, w_hh, h0,
                                                                     c0)))
    c_prev = jnp.concatenate([jnp.asarray(c0)[None], c_all[:-1]])
    if mode == "high":
        want = JT._pallas_bwd(jnp.asarray(dh), jnp.asarray(dc), gates, c_prev, m3, whi, wlo,
                              hidden=H, interpret=True, precision=HIGH)
    else:
        want = _bwd_scan_bf16(jnp.asarray(dh), jnp.asarray(dc), gates, c_prev,
                              jnp.asarray(mask), jnp.asarray(w_hh))
    args = _t(dh, dc, gates, c_prev, mask, w_hh)
    got = TK.lstm_train_bwd_plain(*args, mode)
    flow = _reverse_sweep_split_once(*args, mode)
    assert all(torch.equal(a, b) for a, b in zip(got, flow))
    assert all(torch.equal(a, b) for a, b in zip(TK.lstm_train_bwd(*args, mode), flow))
    if mode == "high":
        _close(flow, want, BWD_HIGH_TOL)
        assert _max_diff(flow, want) < _max_diff(TK.lstm_train_bwd_plain(*args, "highest"), want)
    else:
        _close(flow, want, DEFAULT_EMUL_TOL)
    assert (flow[0][:, 3] == 0).all()  # the 0-length row: zero dgates


# ---------------------------------------------------------------------------
# DEFAULT against a bf16 JAX scan and its VJP


@jax.custom_vjp
def _bf16_mm(a, b):
    """a @ b with bf16 inputs and f32 sums; both gradients products of the
    same kind (JAX's transpose of a DEFAULT dot on the TPU)."""
    return lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                           (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _bf16_mm_fwd(a, b):
    return _bf16_mm(a, b), (a, b)


def _bf16_mm_bwd(res, g):
    a, b = res
    a2, g2 = a.reshape(-1, a.shape[-1]), g.reshape(-1, g.shape[-1])
    return _bf16_mm(g, b.T), _bf16_mm(a2.T, g2)


_bf16_mm.defvjp(_bf16_mm_fwd, _bf16_mm_bwd)


def _core_scan_bf16(x_proj, mask, w_hh, h0, c0):
    """The masked recurrence with its product at DEFAULT: (gates, h_all, c_all)."""
    def step(carry, inp):
        hp, cp = carry
        xpt, m = inp
        gates = xpt + _bf16_mm(hp, w_hh)
        i = jax.nn.sigmoid(gates[:, :H])
        fo = jax.nn.sigmoid(gates[:, H:2 * H])
        g = jnp.tanh(gates[:, 2 * H:3 * H])
        o = jax.nn.sigmoid(gates[:, 3 * H:])
        cn = fo * cp + i * g
        hn = o * jnp.tanh(cn)
        m1 = m[:, None]
        h, c = jnp.where(m1 > 0, hn, hp), jnp.where(m1 > 0, cn, cp)
        return (h, c), (gates, h, c)

    _, (gates, h_all, c_all) = lax.scan(step, (h0, c0), (x_proj, mask))
    return gates, h_all, c_all


def test_plain_pair_default_matches_bf16_scan_and_its_vjp():
    """The plain forward sweep at DEFAULT gives the bf16 scan's gates and
    states (DEFAULT_EMUL_TOL); LSTMCore's gradients (dx_proj = dgates,
    dW_hh, dh0, dc0) give its VJP's (DEFAULT_GRAD_SCALE); and both lie
    within bf16's level of the JAX pair at HIGHEST, far from it beside the
    scan."""
    x_proj, mask, w_hh, h0, c0, dh, dc = _pair_inputs(3)
    jargs = tuple(jnp.asarray(a) for a in (x_proj, mask, w_hh, h0, c0))
    want = _core_scan_bf16(*jargs)
    args = _t(x_proj, mask, w_hh, h0, c0)
    _close(TK.lstm_train_fwd_plain(*args, True, "default"), want, DEFAULT_EMUL_TOL)

    def core(xp, w, h, c):
        return _core_scan_bf16(xp, jargs[1], w, h, c)[1:]

    _, vjp = jax.vjp(core, jargs[0], jargs[2], jargs[3], jargs[4])
    want_grads = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    leaves = [t.clone().requires_grad_() for t in (args[0], args[2], args[3], args[4])]
    h_all, c_all = TK.LSTMCore.apply(leaves[0], args[1], leaves[1], leaves[2], leaves[3],
                                     TK.lstm_train_fwd, TK.lstm_train_bwd, "default")
    _close((h_all, c_all), want[1:], DEFAULT_EMUL_TOL)
    grads = torch.autograd.grad((h_all * torch.from_numpy(dh)).sum()
                                + (c_all * torch.from_numpy(dc)).sum(), leaves)
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        _close((g,), (w,), dict(rtol=0, atol=DEFAULT_GRAD_SCALE * (1 + np.abs(w).max())))

    # Against the JAX pair at HIGHEST: bf16's level.
    j_hi = jax.vjp(lambda xp, w, h, c: JT._lstm_core(xp, jargs[1], w, h, c, H, True,
                                                     lax.Precision.HIGHEST),
                   jargs[0], jargs[2], jargs[3], jargs[4])
    _close((h_all, c_all), j_hi[0], BF16_TOL)
    _close(grads, j_hi[1]((jnp.asarray(dh), jnp.asarray(dc))), dict(rtol=0, atol=3e-2))
    assert _max_diff(grads, want_grads) < 1e-3 < _max_diff(grads, j_hi[1](
        (jnp.asarray(dh), jnp.asarray(dc))))


# ---------------------------------------------------------------------------
# The layer functions


def _cell(seed, i=20, h=H, bidirectional=False):
    params = JL.lstm_init(jax.random.PRNGKey(seed), i, h, 1, bidirectional=bidirectional)
    return params


def _t_cell(cell):
    return {k: torch.from_numpy(np.array(v)) for k, v in cell.items()}


@pytest.mark.parametrize("mode", MODES)
def test_lstm_cell_train_at_mode(mode):
    """``lstm_cell_train`` at the mode: outputs, final states and every
    gradient (cell weights, x, h0, c0). At HIGH against the JAX pair at HIGH
    in interpret mode (its input projection and dW_hh are f32 on this CPU,
    the port's bf16_3x): outputs atol 1e-5, each gradient atol 1e-5 (1 +
    max |JAX gradient|); at DEFAULT against the same layer written here
    with every product a bf16 product (DEFAULT_EMUL_TOL, gradients
    DEFAULT_GRAD_SCALE); and both within bf16's level of the JAX pair at
    HIGHEST."""
    cell = _cell(11)["layers"][0]["fwd"]
    rng = np.random.RandomState(4)
    x = rng.randn(F, N, 20).astype(np.float32)
    _, mask, _, h0, c0, dh, _ = _pair_inputs(4)
    w_out = rng.randn(F, N, H).astype(np.float32)
    w_c = rng.randn(N, H).astype(np.float32)

    def j_loss(prec):
        def loss(cl, xs, h, c):
            if prec == "default":
                xp = _bf16_mm(xs, cl["w_ih"]) + cl["b_ih"] + cl["b_hh"]
                _, h_all, c_all = _core_scan_bf16(xp, jnp.asarray(mask), cl["w_hh"], h, c)
                outs, cF = h_all * jnp.asarray(mask)[:, :, None], c_all[-1]
            else:
                outs, (_, cF) = JT.lstm_cell_train_pallas(cl, xs, jnp.asarray(mask), h, c,
                                                          precision=prec, interpret=True)
            return (outs * w_out).sum() + (cF * w_c).sum(), outs
        return loss

    def t_loss():
        tc = {k: v.clone().requires_grad_() for k, v in _t_cell(cell).items()}
        leaves = [t.clone().requires_grad_() for t in _t(x, h0, c0)]
        outs, (_, cF) = TK.lstm_cell_train(tc, leaves[0], torch.from_numpy(mask), leaves[1],
                                           leaves[2], precision=mode)
        loss = (outs * torch.from_numpy(w_out)).sum() + (cF * torch.from_numpy(w_c)).sum()
        names = sorted(tc)
        grads = torch.autograd.grad(loss, [tc[k] for k in names] + leaves)
        return outs, dict(zip(names + ["x", "h0", "c0"], grads))

    def j_run(prec):
        (_, outs), g = jax.value_and_grad(j_loss(prec), argnums=(0, 1, 2, 3), has_aux=True)(
            cell, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
        return outs, dict(sorted(g[0].items()), x=g[1], h0=g[2], c0=g[3])

    outs, grads = t_loss()
    ref = j_run(HIGH if mode == "high" else "default")
    _close((outs,), (ref[0],), dict(rtol=0, atol=1e-5) if mode == "high" else DEFAULT_EMUL_TOL)
    scale = 1e-5 if mode == "high" else DEFAULT_GRAD_SCALE
    for k in grads:
        w = np.asarray(ref[1][k])
        _close((grads[k],), (w,), dict(rtol=0, atol=scale * (1 + np.abs(w).max())), msg=k)
    hi = j_run(lax.Precision.HIGHEST)
    _close((outs,), (hi[0],), BF16_TOL)
    for k in grads:
        w = np.asarray(hi[1][k])
        _close((grads[k],), (w,), dict(rtol=0, atol=2e-2 * (1 + np.abs(w).max())), msg=k)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bidi"])
@pytest.mark.parametrize("mode", MODES)
def test_lstm_apply_training_at_mode(mode, bidirectional):
    """``lstm_apply(inference=False)`` of a 2-layer LSTM at the NN knob's
    mode against JAX's ``lstm_apply`` with its knob at the mode and its
    training pair in interpret mode (batch 9): outputs, final states and
    every weight's gradient. At HIGH within rtol 1e-5, atol 5e-5 (JAX's
    projections and dW_hh are f32 on this CPU); at DEFAULT within bf16's
    level, and moved from the port at HIGHEST."""
    n, f, i, h = 9, 10, 12, 32
    params = JL.lstm_init(jax.random.PRNGKey(5), i, h, 2, bidirectional=bidirectional)
    rng = np.random.RandomState(6)
    x = rng.randn(n, f, i).astype(np.float32)
    lengths = np.array([10, 3, 0, 10, 7, 1, 10, 9, 5])
    dirs = 2 if bidirectional else 1
    w_out = rng.randn(n, f, h * dirs).astype(np.float32)
    lstm = TL.LSTM(i, h, 2, bidirectional=bidirectional)
    sd = {}
    for l, layer in enumerate(params["layers"]):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse"))[:dirs]:
            c = layer[d]
            sd[f"weight_ih_l{l}{suffix}"] = torch.from_numpy(np.array(c["w_ih"]).T.copy())
            sd[f"weight_hh_l{l}{suffix}"] = torch.from_numpy(np.array(c["w_hh"]).T.copy())
            sd[f"bias_ih_l{l}{suffix}"] = torch.from_numpy(np.array(c["b_ih"]))
            sd[f"bias_hh_l{l}{suffix}"] = torch.from_numpy(np.array(c["b_hh"]))
    lstm.load_state_dict(sd)

    def t_run(prec):
        lstm.zero_grad()
        with precision_scope(prec):
            out, (hF, _) = TL.lstm_apply(lstm, torch.from_numpy(x), torch.from_numpy(lengths),
                                         inference=False)
        ((out * torch.from_numpy(w_out)).sum() + hF.sum()).backward()
        return out.detach(), {k: p.grad.clone() for k, p in lstm.named_parameters()}

    out, grads = t_run(mode)
    base, _ = t_run("highest")
    old = (JL.LSTM_TRAIN_KERNEL, JL._HI)
    try:
        JL.LSTM_TRAIN_KERNEL = "interpret"
        JL.set_nn_precision(mode)

        def loss(p):
            o, (hF, _) = JL.lstm_apply(p, jnp.asarray(x), jnp.asarray(lengths), inference=False)
            return (o * w_out).sum() + hF.sum(), o

        (_, j_out), j_g = jax.value_and_grad(loss, has_aux=True)(params)
    finally:
        JL.LSTM_TRAIN_KERNEL, JL._HI = old
    tol = dict(rtol=1e-5, atol=5e-5) if mode == "high" else BF16_TOL
    _close((out,), (j_out,), tol)
    for l, layer in enumerate(j_g["layers"]):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse"))[:dirs]:
            for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih")):
                w = np.asarray(layer[d][k])
                w = w.T if k.startswith("w") else w
                g = grads[f"{name}_l{l}{suffix}"]
                t = tol if mode == "high" else dict(rtol=0, atol=2e-2 * (1 + np.abs(w).max()))
                _close((g,), (w,), t, msg=f"{name}_l{l}{suffix}")
    moved = float((out - base).abs().max())
    assert (moved > 1e-4) if mode == "default" else (0 < moved < 1e-4), moved


def test_lstm_core_makes_the_weight_form_once_per_step(monkeypatch):
    """At HIGH and DEFAULT a training step splits (or rounds) W_hh once, in
    LSTMCore's forward, and both sweeps take that form: no weight_parts
    call, and bf16_parts sees W_hh's shape once (the other calls are
    dgates' for dW_hh)."""
    seen = []
    real = TK.bf16_parts

    def counting(x, mode):
        seen.append(tuple(x.shape))
        return real(x, mode)

    def refuse(w, mode):
        raise AssertionError("the sweeps made W_hh's form themselves")

    monkeypatch.setattr(TK, "bf16_parts", counting)
    monkeypatch.setattr(TK, "weight_parts", refuse)
    cell = {k: v.requires_grad_() for k, v in _t_cell(_cell(2)["layers"][0]["fwd"]).items()}
    x = torch.randn(F, N, 20)
    mask = torch.ones(F, N)
    for mode in MODES:
        seen.clear()
        outs, (hF, cF) = TK.lstm_cell_train(cell, x, mask, torch.zeros(N, H), torch.zeros(N, H),
                                            precision=mode)
        (outs.sum() + cF.sum()).backward()
        assert seen.count((H, 4 * H)) == 1, (mode, seen)
        assert seen == [(H, 4 * H), (F * N, 4 * H)], (mode, seen)


# ---------------------------------------------------------------------------
# Whole train steps and the trainer


def _flags_mode(flags):
    cfg = Configuration.from_dict(dict(TRAIN_CFG, **flags))
    return TLoop._precision(cfg)


@pytest.mark.parametrize("kind, flags", [
    ("lgd", dict(matmul_precision="high")), ("lgd", dict(matmul_precision="default")),
    ("lgd", dict(bf16=True)), ("birnn", dict(matmul_precision="high")),
    ("birnn", dict(matmul_precision="default")), ("birnn", dict(bf16=True)),
], ids=["lgd-high", "lgd-default", "lgd-bf16", "birnn-high", "birnn-default", "birnn-bf16"])
def test_train_step_at_mode_matches_jax(sensors, assets_env, kind, flags):
    """One train step of a tiny LGD-RNN (init RNN 2x32) and BiRNN (2x16) at
    the mode the flags give: the port's ``Trainer`` binds both knobs (NN and
    kinematics) to it, and its ``loss`` (the loss, its parts, the reference
    gradient term) and every parameter gradient are held against
    ``jax.grad`` of the JAX train forward with the JAX trainer's two knobs
    at the mode (``empose_tpu/train/loop.py``) and its training pair in
    interpret mode (batch 9). At HIGH: losses rtol 1e-4, gradients atol
    1e-3 (1 + max |JAX gradient|) (JAX's GEMMs are f32 on this CPU, only
    its pair's products bf16_3x); at DEFAULT the port's products are bf16
    and JAX's f32 here: losses rtol 3e-2, gradients atol 0.1 (1 + max)."""
    j_sensor, t_sensor = sensors
    mode = _flags_mode(flags)
    cfg_dict = dict(TRAIN_CFG, n_markers=6) if kind == "lgd" else \
        dict(RNN_COMMON, n_markers=6, m_type="rnn", m_bidirectional=True)
    cfg, params, state = _jax_params(cfg_dict, j_sensor, seed=21)
    t_cfg = Configuration.from_dict(dict(cfg_dict, use_real_offsets=True, **flags))
    j_model = j_create_model(cfg, j_sensor)
    win = _batch(9, seed=kind == "lgd")
    scale = _pad_scale(win["seq_lengths"])
    old = (JL.LSTM_TRAIN_KERNEL, JL._HI)
    from empose_tpu.ops import fk_lanes
    old_fk = fk_lanes._HI
    try:
        JL.LSTM_TRAIN_KERNEL = "interpret"
        JL.set_nn_precision(mode)
        j_set_fk_precision(mode)

        def loss_fn(p, w):
            out, _, _ = j_model.forward(p, state, w, train=True)
            total, vals = j_model.compute_loss(w, out)
            extra = j_model.reference_grad_extra_loss(out) if kind == "lgd" else 0.0
            return (total + extra) * scale, {k: v * scale for k, v in vals.items()}

        j_grads, j_vals = jax.jit(jax.grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in win.items()})
    finally:
        JL.LSTM_TRAIN_KERNEL, JL._HI = old
        fk_lanes._HI = old_fk

    try:
        trainer = TLoop.Trainer(t_cfg, device="cpu")
        assert nn_precision() == fk_precision() == mode
        model = create_model(t_cfg, t_sensor).train()
        model.load_state_dict(state_dict_from_jax(params, state, t_cfg), strict=True)
        trainer.model = model
        t_win = {k: torch.from_numpy(v.astype(np.int64) if k == "seq_lengths" else v)
                 for k, v in win.items()}
        loss, vals = trainer.loss(t_win)
        loss.backward()
    finally:
        TL.set_nn_precision("highest")
        from empose_tpu_torch.nn.models import set_fk_precision
        set_fk_precision("highest")
    hi = mode == "high"
    for k, v in vals.items():
        np.testing.assert_allclose(float(v), float(j_vals[k]), rtol=1e-4 if hi else 3e-2,
                                   atol=1e-6, err_msg=k)
    want = grads_from_jax(jax.device_get(j_grads), t_cfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=(1e-3 if hi else 0.1) * (1.0 + np.abs(w).max()),
                                   err_msg=k)


def test_cli_bf16_resume_matches_uninterrupted_run(assets_env, tmp_path, monkeypatch):
    """A tiny BiRNN trained through the CLI at --bf16: 2 steps, then
    --resume to 3, equal an uninterrupted 3-step run bit for bit (losses and
    weights); the run trains at ``default`` and leaves the knobs bound."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    flags = TINY_BIRNN + ["--bf16"]
    try:
        full_dir, full = main(flags + ["--experiment_id", "700011", "--max_steps", "3"])
        assert nn_precision() == fk_precision() == "default"
        main(flags + ["--experiment_id", "700012", "--max_steps", "2"])
        part_dir, resumed = main(flags + ["--experiment_id", "700012", "--max_steps", "3",
                                          "--resume"])
    finally:
        TL.set_nn_precision("highest")
        from empose_tpu_torch.nn.models import set_fk_precision
        set_fk_precision("highest")
    assert resumed.global_step == 3
    want, got = _losses(full_dir), _losses(part_dir)
    assert sorted(got) == sorted(want) == [1, 2, 3]
    assert got == want and all(np.isfinite(v) for v in got.values())
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_bf16_with_another_precision_raises(assets_env):
    """``--bf16 --matmul_precision high`` is ambiguous and raises before
    anything is built, as in the JAX trainer; ``--bf16`` alone and with
    ``--matmul_precision default`` mean default."""
    assert _flags_mode(dict(bf16=True)) == "default"
    assert _flags_mode(dict(bf16=True, matmul_precision="default")) == "default"
    assert _flags_mode(dict(matmul_precision="high")) == "high"
    cfg = Configuration.from_dict(dict(TRAIN_CFG, bf16=True, matmul_precision="high"))
    with pytest.raises(ValueError, match="--bf16 conflicts with --matmul_precision high"):
        TLoop.Trainer(cfg, device="cpu")
    assert nn_precision() == "highest"


def test_lstm_train_plans_read_the_mode_bytes():
    """The pair's plans at high and default: HIGHEST's grid with U >= 2;
    the forward sweep a ring of 16-row bf16 chunks: where a step has two
    chunks or more and two slots fit beside the fragments and two buffers
    of partial tiles, two teams of 4 warps on as many slots as fit there
    (H=512: 12 default, 5 high; H=1024 default: 4) up to 8 and the step's
    chunks, else one team, one slot and one buffer; the reverse sweep a ring of
    16-row k-slices, 4H in the fewest slices of a multiple of 128 columns
    (or all 4H) of which two stages fit (H=512: 2048 default, 1024 high;
    H=1024: 2048, 640), as many stages as fit up to 8 and the step's stages
    (at least 2), the step operands resident where they fit beside that
    ring; bytes by the kernels' layouts; plans for every (N, H) that
    HIGHEST plans, raising only where HIGHEST's do."""
    frags = lambda h, mode: (2 if mode == "high" else 1) * h // 4 * 32 * 8
    for mode, fit512, fit1024 in (("default", 12, 4), ("high", 5, 1)):
        parts = 2 if mode == "high" else 1
        for n in (1, 7, 16, 17, 33, 64, 100, 113, 1300):
            chunks = -(-n // 16)
            for h, units, fit in ((512, 4, fit512), (1024, 8, fit1024)):
                teams = 2 if chunks > 1 and fit > 1 else 1
                stages = min(8, chunks, fit) if teams == 2 else 1
                smem = (parts * 8 * units * h + stages * parts * 16 * h * 2 + 144
                        + teams * 8 * 16 * 4 * units * 4)
                assert TK.lstm_train_fwd_plan(n, h, precision=mode) == TK.FwdPlan(
                    units, h // units, 16 * stages, teams, smem), (mode, n, h)
            for h, units, k_cols in ((512, 4, 2048 // parts),
                                     (1024, 8, 2048 if parts == 1 else 640)):
                plan = TK.lstm_train_bwd_plan(n, h, precision=mode)
                fixed = frags(h, mode) + 128 + 2 * 8 * 16 * 8 * 4
                stage = parts * 16 * k_cols * 2
                fit = (232448 - fixed) // stage
                stages = max(2, min(8, -(-n // 16) * -(-4 * h // k_cols), fit))
                resident = fixed + stages * stage + TK.bwd_operand_bytes(units, n) <= 232448
                assert plan == TK.BwdPlan(units, h // units, 1, 16, 16, stages, resident, k_cols,
                                          TK.bwd_mma_smem_bytes(units, n, h, k_cols, stages,
                                                                resident, mode)), (mode, n, h)
        # H=512: two stages at both modes; the operands resident up to N=113, not at N=1300.
        assert [TK.lstm_train_bwd_plan(n, 512, precision=mode)[5:7] for n in (16, 113, 1300)] \
            == [(2, True), (2, True), (2, False)]
        assert TK.bwd_mma_smem_bytes(4, 64, 512, 1024, 2, True, mode) == (
            parts * (512 // 4 * 32 * 8 + 2 * 16 * 1024 * 2) + 128 + 8 * 16 * 8 * 4 * 2
            + 4 * (7 * 4 * 64 + 64 + 2 * 4 * 64))
        assert TK.lstm_train_fwd_plan(4, 64, precision=mode).units == 2  # HIGHEST: 1
        assert TK.lstm_train_fwd_plan(4, 64).units == 1
        for h in (4, 100, 260, 516, 1000, 1056):
            for n in (1, 16, 300):
                TK.lstm_train_fwd_plan(n, h)
                TK.lstm_train_bwd_plan(n, h)
                assert TK.lstm_train_fwd_plan(n, h, precision=mode).smem_bytes <= 232448
                plan = TK.lstm_train_bwd_plan(n, h, precision=mode)
                assert plan.smem_bytes <= 232448 and 2 <= plan.stages <= 8
                assert plan.k_cols == 4 * h or plan.k_cols % 128 == 0
        for plan in (TK.lstm_train_fwd_plan, TK.lstm_train_bwd_plan):
            with pytest.raises(ValueError):
                plan(16, 2048, precision=mode)
            with pytest.raises(ValueError):
                plan(16, 2048)
    assert TK.lstm_train_bwd_plan(16, 512).k_cols == 2048
    with pytest.raises(ValueError, match="unknown precision"):
        TK.lstm_train_fwd_plan(16, 512, precision="bf16")
