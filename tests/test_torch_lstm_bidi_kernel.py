"""The port's bidirectional LSTM layer (plain version of the CUDA kernel)
against the JAX package.

Reference: ``empose_tpu.ops.lstm_kernel._pallas_bidi`` and
``lstm_bidi_layer_pallas`` in Pallas interpret mode, and the JAX
``lstm_apply`` at inference through its bidirectional kernel route (batch 17,
interpret mode) and its scan route (batch 3). Tolerance atol 1e-5, rtol
1e-5: fp32 on both sides, the same formulas, another matmul summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from empose_tpu.nn import layers as JL
from empose_tpu.ops.lstm_kernel import _pallas_bidi, lstm_bidi_layer_pallas

from empose_tpu_torch.nn import layers as TL
from empose_tpu_torch.ops import lstm_kernel as K

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
F, N, I, H = 9, 17, 7, 16


def _lengths(n, f, seed):
    """0-length, 1-frame, partial and full rows."""
    lengths = np.random.RandomState(seed).randint(2, f, n)
    lengths[:3] = [0, 1, f]
    lengths[-2:] = [f, 0]
    return lengths


def _case(seed):
    rng = np.random.RandomState(seed)
    b = 1.0 / np.sqrt(H)
    cells = [{
        "w_ih": rng.uniform(-b, b, (I, 4 * H)).astype(np.float32),
        "w_hh": rng.uniform(-b, b, (H, 4 * H)).astype(np.float32),
        "b_ih": rng.uniform(-b, b, (4 * H,)).astype(np.float32),
        "b_hh": rng.uniform(-b, b, (4 * H,)).astype(np.float32),
    } for _ in range(2)]
    lengths = _lengths(N, F, seed)
    x = rng.randn(F, N, I).astype(np.float32)
    x_rev = np.array(JL._reverse_by_length(jnp.asarray(x), jnp.asarray(lengths)))
    mask = (np.arange(F)[:, None] < lengths[None, :]).astype(np.float32)
    h0 = (rng.randn(2, N, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(2, N, H) * 0.5).astype(np.float32)
    return cells, x, x_rev, mask, h0, c0, lengths


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("reference", ["pallas_bidi", "lstm_bidi_layer_pallas"])
def test_plain_matches_pallas_interpret(reference):
    """``lstm_bidi_plain`` against the Pallas kernel on the same x_proj, and
    ``lstm_bidi_layer`` (projections included) against the JAX entry point;
    0-length rows frozen bit for bit, outputs zero at masked steps."""
    cells, x, x_rev, mask, h0, c0, lengths = _case(seed=1 if reference == "pallas_bidi" else 2)
    t_cells = [{k: torch.from_numpy(v) for k, v in c.items()} for c in cells]
    launches = K.BIDI_LAUNCHES
    if reference == "pallas_bidi":
        x_proj = np.stack([xs @ c["w_ih"] + c["b_ih"] + c["b_hh"]
                           for c, xs in zip(cells, (x, x_rev))], axis=1)
        w_hh2 = np.stack([c["w_hh"] for c in cells])
        want = _pallas_bidi(jnp.asarray(x_proj), jnp.asarray(mask[:, :, None]), jnp.asarray(w_hh2),
                            jnp.asarray(h0), jnp.asarray(c0), hidden=H, interpret=True,
                            precision=lax.Precision.HIGHEST)
        got = K.lstm_bidi_plain(*_t(x_proj, mask, w_hh2, h0, c0))
    else:
        j_cells = [{k: jnp.asarray(v) for k, v in c.items()} for c in cells]
        outs, (hF, cF) = lstm_bidi_layer_pallas(j_cells[0], j_cells[1], *map(jnp.asarray, (
            x, x_rev, mask, h0, c0)), interpret=True)
        want = (outs, hF, cF)
        outs, (hF, cF) = K.lstm_bidi_layer(t_cells[0], t_cells[1], *_t(x, x_rev, mask, h0, c0))
        got = (outs, hF, cF)
    assert K.BIDI_LAUNCHES == launches  # CPU tensors: the plain version, no launch
    for name, g, w in zip(("outs", "hF", "cF"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    outs, hF, cF = got
    idle = lengths == 0
    assert np.array_equal(hF[:, idle].numpy(), h0[:, idle])
    assert np.array_equal(cF[:, idle].numpy(), c0[:, idle])
    assert not outs.permute(0, 2, 1, 3)[torch.from_numpy(mask) == 0].any()


@pytest.mark.parametrize("batch", [3, 17], ids=["scan", "pallas_interpret"])
def test_lstm_apply_bidirectional_inference_matches_jax(monkeypatch, batch):
    """Two bidirectional layers at inference with a carried state: every
    layer runs through ``bidi_fn`` once; outputs and torch-layout finals equal
    JAX ``lstm_apply`` (kernel route at batch 17, scan at batch 3)."""
    if batch >= JL.LSTM_KERNEL_MIN_BATCH:
        monkeypatch.setattr(JL, "LSTM_KERNEL", "interpret")
    num_layers = 2
    rng = np.random.RandomState(batch)
    j_params = JL.lstm_init(jax.random.PRNGKey(batch), I, H, num_layers, bidirectional=True)
    lstm = TL.LSTM(I, H, num_layers, bidirectional=True)
    with torch.no_grad():
        for l, layer in enumerate(j_params["layers"]):
            for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
                for k in ("ih", "hh"):
                    getattr(lstm, f"weight_{k}_l{l}{suffix}").copy_(
                        torch.from_numpy(np.array(layer[d][f"w_{k}"]).T.copy()))
                    getattr(lstm, f"bias_{k}_l{l}{suffix}").copy_(
                        torch.from_numpy(np.array(layer[d][f"b_{k}"])))
    lengths = _lengths(batch, F, seed=batch)
    x = rng.randn(batch, F, I).astype(np.float32)
    h0 = (rng.randn(2 * num_layers, batch, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(2 * num_layers, batch, H) * 0.3).astype(np.float32)
    j_out, (j_h, j_c) = JL.lstm_apply(j_params, jnp.asarray(x), jnp.asarray(lengths),
                                      (jnp.asarray(h0), jnp.asarray(c0)), inference=True)
    calls = []

    def bidi_fn(*args):
        calls.append(args[0].shape)
        return K.lstm_bidi_fused(*args)

    with torch.no_grad():
        out, (hF, cF) = TL.lstm_apply(lstm, *_t(x, lengths), _t(h0, c0), inference=True,
                                      bidi_fn=bidi_fn)
    assert calls == [(F, 2, batch, 4 * H)] * num_layers
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(hF.numpy(), np.asarray(j_h), **TOL)
    np.testing.assert_allclose(cF.numpy(), np.asarray(j_c), **TOL)


def test_wrapper_refuses_other_devices():
    """A non-CPU, non-CUDA tensor is refused rather than run through the
    plain version."""
    cells, x, x_rev, mask, h0, c0, _ = _case(seed=5)
    x_proj = torch.zeros(F, 2, N, 4 * H, device="meta")
    w_hh2 = torch.zeros(2, H, 4 * H, device="meta")
    with pytest.raises(ValueError, match="no bidirectional LSTM kernel"):
        K.lstm_bidi_fused(x_proj, *(t.to("meta") for t in _t(mask)), w_hh2,
                          *(t.to("meta") for t in _t(h0, c0)))


@pytest.mark.parametrize("bad, error", [
    (lambda t: None, "is required"),
    (lambda t: t.double(), "float32"),
    (lambda t: t[..., :-1], "shape"),
    (lambda t: t.transpose(-1, -2).contiguous().transpose(-1, -2), "contiguous"),
], ids=["missing", "dtype", "shape", "strides"])
def test_operand_checks_before_launch(bad, error):
    """The checks the wrapper runs on every operand before a launch."""
    t = torch.zeros(2, N, H)
    K._check("h0", t, (2, N, H), t.device)
    with pytest.raises(ValueError, match=error):
        K._check("h0", bad(t), (2, N, H), t.device)


@pytest.mark.parametrize("h, n", [(512, n) for n in (1, 7, 16, 64, 81, 82, 100, 1300, 100000)]
                         + [(1024, n) for n in (1, 25, 32, 1300)]
                         + [(64, 1), (64, 100), (260, 7), (516, 7)])
def test_bidi_launch_plan_fits(h, n):
    """The pure-Python launch plan: within a block's shared memory and equal
    to the layout's formula; U=8 where 8 divides H, else U=4; both
    directions in one grid where 2H / U blocks fit on the SMs (H=512, 64,
    260), else one direction per launch (H=1024, 516); a co-resident grid of
    one block per SM; a ring of 16-row slots only where the N rows do not
    fit, and then no more bytes for more rows."""
    plan = K.lstm_bidi_plan(n, h)
    assert plan.smem_bytes <= 232448
    assert plan.smem_bytes == K.bidi_smem_bytes(plan.units, h, plan.stage_rows)
    assert plan.units == (8 if h % 8 == 0 else 4) and h % plan.units == 0
    assert (plan.dirs, plan.launches) == ((1, 2) if h in (1024, 516) else (2, 1))
    assert plan.blocks == plan.dirs * h // plan.units <= K.SMS
    all_rows = K.bidi_smem_bytes(plan.units, h, n)
    if all_rows <= K.SMEM_LIMIT:
        assert plan.stage_rows == n
    else:
        assert plan.stage_rows < n and plan.stage_rows % K.PASS_ROWS == 0
        assert 1 <= plan.stage_rows // K.PASS_ROWS <= K.MAX_SLOTS
        assert plan.smem_bytes == K.lstm_bidi_plan(10 * n, h).smem_bytes


@pytest.mark.parametrize("n, h", [(0, 512), (4, 510), (4, 1028), (4, 4096)])
def test_bidi_launch_plan_refusals(n, h):
    """No plan for an empty batch, an H the float4 rows cannot hold, or an H
    whose H / U blocks of one direction do not fit on the SMs."""
    with pytest.raises(ValueError):
        K.lstm_bidi_plan(n, h)


def test_lstm_apply_default_width_bidirectional_matches_jax():
    """A 2-layer bidirectional LSTM at the default width H=1024 at inference,
    ragged lengths, carried state: the port's ``lstm_apply`` (plain versions
    on the CPU) equals JAX ``lstm_apply`` (its scan route, which JAX takes at
    this width); each layer goes to ``bidi_fn`` once, and its plan launches
    the kernel once per direction."""
    hidden, num_layers, batch, f = 1024, 2, 3, 4
    rng = np.random.RandomState(11)
    j_params = JL.lstm_init(jax.random.PRNGKey(11), I, hidden, num_layers, bidirectional=True)
    lstm = TL.LSTM(I, hidden, num_layers, bidirectional=True)
    with torch.no_grad():
        for l, layer in enumerate(j_params["layers"]):
            for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
                for k in ("ih", "hh"):
                    getattr(lstm, f"weight_{k}_l{l}{suffix}").copy_(
                        torch.from_numpy(np.array(layer[d][f"w_{k}"]).T.copy()))
                    getattr(lstm, f"bias_{k}_l{l}{suffix}").copy_(
                        torch.from_numpy(np.array(layer[d][f"b_{k}"])))
    lengths = np.array([f, 0, 2])
    x = rng.randn(batch, f, I).astype(np.float32)
    h0 = (rng.randn(2 * num_layers, batch, hidden) * 0.3).astype(np.float32)
    c0 = (rng.randn(2 * num_layers, batch, hidden) * 0.3).astype(np.float32)
    j_out, (j_h, j_c) = JL.lstm_apply(j_params, jnp.asarray(x), jnp.asarray(lengths),
                                      (jnp.asarray(h0), jnp.asarray(c0)), inference=True)
    launches = []

    def bidi_fn(*args):
        launches.append(K.lstm_bidi_plan(args[0].shape[2], args[2].shape[1]).launches)
        return K.lstm_bidi_fused(*args)

    with torch.no_grad():
        out, (hF, cF) = TL.lstm_apply(lstm, *_t(x, lengths), _t(h0, c0), inference=True,
                                      bidi_fn=bidi_fn)
    assert launches == [2] * num_layers
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(hF.numpy(), np.asarray(j_h), **TOL)
    np.testing.assert_allclose(cF.numpy(), np.asarray(j_c), **TOL)
