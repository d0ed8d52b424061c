"""The port's LSTM stack (plain version of the CUDA kernel) against the JAX package.

Reference: ``empose_tpu.ops.lstm_kernel.lstm_stack_pallas`` in Pallas interpret
mode and ``empose_tpu.nn.layers._lstm_cell_scan`` layer by layer. Tolerance
atol 1e-5: both sides are fp32 with the same op order up to the matmul
summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empose_tpu.nn import layers as JL
from empose_tpu.ops.lstm_kernel import lstm_stack_pallas

from empose_tpu_torch.nn import layers as TL
from empose_tpu_torch.ops import lstm_kernel as K

torch.set_num_threads(1)
ATOL = 1e-5
F, N, I, H = 9, 5, 7, 32
LENGTHS = np.array([9, 0, 4, 9, 1])  # full, empty, partial, full, one frame


def _case(num_layers, seed):
    rng = np.random.RandomState(seed)
    b = 1.0 / np.sqrt(H)
    cells = [{
        "w_ih": rng.uniform(-b, b, (I if l == 0 else H, 4 * H)).astype(np.float32),
        "w_hh": rng.uniform(-b, b, (H, 4 * H)).astype(np.float32),
        "b_ih": rng.uniform(-b, b, (4 * H,)).astype(np.float32),
        "b_hh": rng.uniform(-b, b, (4 * H,)).astype(np.float32),
    } for l in range(num_layers)]
    x = rng.randn(F, N, I).astype(np.float32)
    mask = (np.arange(F)[:, None] < LENGTHS[None, :]).astype(np.float32)
    h0 = (rng.randn(num_layers, N, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(num_layers, N, H) * 0.5).astype(np.float32)
    return cells, x, mask, h0, c0


def _torch(cells, *arrays):
    return ([{k: torch.from_numpy(v) for k, v in c.items()} for c in cells],
            *(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_matches_pallas_interpret_and_scan(num_layers):
    cells, x, mask, h0, c0 = _case(num_layers, seed=num_layers)
    j_cells = [{k: jnp.asarray(v) for k, v in c.items()} for c in cells]
    j_out, (j_h, j_c) = lstm_stack_pallas(j_cells, jnp.asarray(x), jnp.asarray(mask),
                                          jnp.asarray(h0), jnp.asarray(c0), interpret=True)
    xt, hs, cs = jnp.asarray(x), [], []
    for l, cell in enumerate(j_cells):
        xt, (hF, cF) = JL._lstm_cell_scan(cell, xt, jnp.asarray(mask), jnp.asarray(h0[l]),
                                          jnp.asarray(c0[l]))
        hs.append(hF)
        cs.append(cF)

    t_cells, tx, tm, th0, tc0 = _torch(cells, x, mask, h0, c0)
    launches = K.LAUNCHES
    out, (hF, cF) = K.lstm_stack(t_cells, tx, tm, th0, tc0)
    assert K.LAUNCHES == launches  # CPU tensors: the plain version, no launch
    for got, pallas, scan in ((out, j_out, xt), (hF, j_h, jnp.stack(hs)), (cF, j_c, jnp.stack(cs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(scan), atol=ATOL)
    # 0-length row: state frozen bit for bit, outputs zero.
    assert np.array_equal(hF[:, 1].numpy(), h0[:, 1]) and np.array_equal(cF[:, 1].numpy(), c0[:, 1])
    assert not out[:, 1].any() and not out[4:, 2].any()


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_apply_matches_jax(bidirectional):
    """The port's lstm_apply (batch-first, torch-layout carry) == JAX lstm_apply."""
    num_layers, n, f = 2, 5, 9
    rng = np.random.RandomState(7 + bidirectional)
    j_params = JL.lstm_init(jax.random.PRNGKey(3), I, H, num_layers, bidirectional)
    lstm = TL.LSTM(I, H, num_layers, bidirectional)
    with torch.no_grad():
        for l, layer in enumerate(j_params["layers"]):
            for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
                if d in layer:
                    for k in ("w_ih", "w_hh"):
                        name = f"weight_{k[2:]}_l{l}{suffix}"
                        getattr(lstm, name).copy_(torch.from_numpy(np.array(layer[d][k]).T.copy()))
                    for k in ("b_ih", "b_hh"):
                        getattr(lstm, f"bias_{k[2:]}_l{l}{suffix}").copy_(
                            torch.from_numpy(np.array(layer[d][k])))
    dirs = 2 if bidirectional else 1
    x = rng.randn(n, f, I).astype(np.float32)
    h0 = (rng.randn(num_layers * dirs, n, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(num_layers * dirs, n, H) * 0.3).astype(np.float32)
    j_out, (j_h, j_c) = JL.lstm_apply(j_params, jnp.asarray(x), jnp.asarray(LENGTHS),
                                      (jnp.asarray(h0), jnp.asarray(c0)))
    with torch.no_grad():
        out, (hF, cF) = TL.lstm_apply(lstm, torch.from_numpy(x), torch.from_numpy(LENGTHS),
                                      (torch.from_numpy(h0), torch.from_numpy(c0)))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(hF.numpy(), np.asarray(j_h), atol=ATOL)
    np.testing.assert_allclose(cF.numpy(), np.asarray(j_c), atol=ATOL)


@pytest.mark.parametrize("layers, h, fits", [(2, 512, True), (2, 1024, False), (1, 1024, True)])
def test_stack_fits_one_launch(layers, h, fits):
    """The stack kernel's one-launch check, from its launch plan: the
    released 2x512 fits, the default 2x1024 does not (the columns of two
    layers of 1024 exceed a block's shared memory), one layer of 1024 does."""
    assert K.lstm_stack_fits(layers, h) is fits
    if fits:
        assert K.lstm_stack_plan(layers, K.PASS_ROWS, h).smem_bytes <= K.SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="does not fit"):
            K.lstm_stack_plan(layers, K.PASS_ROWS, h)


@pytest.mark.parametrize("wavefront", [False, True])
@pytest.mark.parametrize("n", [1, 64, 1300])
@pytest.mark.parametrize("layers, h", [(2, 512), (1, 1024)])
def test_stack_launch_plan_fits(layers, h, n, wavefront):
    """The stack kernel's plan at the released 2x512 and at one layer of the
    default 1024 (the wavefront needs 2 layers): within the block's shared
    memory and the SMs, staged rows all of N or whole 16-row slots, the
    layout of csrc/lstm_stack.cu (resident columns, staged states)."""
    if wavefront and layers < 2:
        with pytest.raises(ValueError, match="needs >= 2 layers"):
            K.lstm_stack_plan(layers, n, h, wavefront=True)
        return
    plan = K.lstm_stack_plan(layers, n, h, wavefront=wavefront)
    assert plan.smem_bytes <= K.SMEM_LIMIT and plan.blocks <= K.SMS
    assert plan.blocks * plan.units == h and plan.units == (4 if h == 512 else 8)
    assert plan.planes == (layers if wavefront else min(layers, 2))
    assert plan.stage_rows == n or (plan.stage_rows % K.PASS_ROWS == 0 and plan.stage_rows < n)
    assert plan.stage_rows <= K.PASS_ROWS * K.MAX_SLOTS or plan.stage_rows == n
    # Two teams of 256 threads at U=4 where a phase has more than one chunk,
    # each with an equal share of a ring.
    assert plan.teams == (2 if plan.units == 4 and n > K.PASS_ROWS else 1)
    assert plan.stage_rows == n or plan.stage_rows // K.PASS_ROWS % plan.teams == 0
    assert plan.smem_bytes == 4 * ((2 * layers - 1) * 4 * plan.units * h
                                   + plan.planes * plan.stage_rows * h)


def test_stack_launch_plan_refusals():
    """No plan for the whole 2x1024 stack in either order (the wrapper runs
    it one layer per launch), nor for bad shapes; a smaller card's limits
    shrink the ring or refuse."""
    for wavefront in (False, True):
        with pytest.raises(ValueError, match="does not fit"):
            K.lstm_stack_plan(2, 64, 1024, wavefront=wavefront)
    for layers, n, h in ((2, 0, 512), (0, 4, 512), (2, 4, 510)):
        with pytest.raises(ValueError, match="positive multiple of 4"):
            K.lstm_stack_plan(layers, n, h)
    one_slot = K.lstm_stack_plan(2, 64, 512, smem_limit=180000)
    assert (one_slot.stage_rows, one_slot.teams) == (K.PASS_ROWS, 1)
    odd = K.lstm_stack_plan(2, 300, 260)  # 5 slots fit: 4, 2 per team
    assert (odd.stage_rows, odd.teams) == (4 * K.PASS_ROWS, 2)
    with pytest.raises(ValueError, match="does not fit on 100 SMs"):
        K.lstm_stack_plan(2, 64, 512, sms=100)


def test_lstm_apply_default_width_matches_jax():
    """A 2-layer unidirectional LSTM at the default width H=1024 at inference,
    ragged lengths, carried state: the port's ``lstm_apply`` (plain versions
    on the CPU) equals JAX ``lstm_apply`` (its scan route, which JAX takes at
    this width), atol 1e-5, rtol 1e-5; the stack does not fit in one launch,
    so ``stack_fn`` runs one layer per call."""
    hidden, num_layers, n, f = 1024, 2, 3, 4
    rng = np.random.RandomState(13)
    j_params = JL.lstm_init(jax.random.PRNGKey(13), I, hidden, num_layers, False)
    lstm = TL.LSTM(I, hidden, num_layers, False)
    with torch.no_grad():
        for l, layer in enumerate(j_params["layers"]):
            for k in ("ih", "hh"):
                getattr(lstm, f"weight_{k}_l{l}").copy_(
                    torch.from_numpy(np.array(layer["fwd"][f"w_{k}"]).T.copy()))
                getattr(lstm, f"bias_{k}_l{l}").copy_(torch.from_numpy(np.array(layer["fwd"][f"b_{k}"])))
    lengths = np.array([f, 0, 2])
    x = rng.randn(n, f, I).astype(np.float32)
    h0 = (rng.randn(num_layers, n, hidden) * 0.3).astype(np.float32)
    c0 = (rng.randn(num_layers, n, hidden) * 0.3).astype(np.float32)
    j_out, (j_h, j_c) = JL.lstm_apply(j_params, jnp.asarray(x), jnp.asarray(lengths),
                                      (jnp.asarray(h0), jnp.asarray(c0)), inference=True)
    layers_per_call = []

    def stack_fn(*args):
        layers_per_call.append(args[2].shape[0])
        return K.lstm_stack_fused(*args)

    with torch.no_grad():
        out, (hF, cF) = TL.lstm_apply(lstm, torch.from_numpy(x), torch.from_numpy(lengths),
                                      (torch.from_numpy(h0), torch.from_numpy(c0)),
                                      stack_fn=stack_fn)
    assert layers_per_call == [1] * num_layers
    for got, want in ((out, j_out), (hF, j_h), (cF, j_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rnn_layer_learned_init_state_slot_swap():
    """RNNLayer with a learned initial state == JAX rnn_layer_apply, including
    the reference quirk that feeds to_init_state_c into the h slot."""
    num_layers, n, f = 2, 5, 9
    rng = np.random.RandomState(9)
    j_params = JL.rnn_layer_init(jax.random.PRNGKey(4), I, H, num_layers, learn_init_state=True)
    layer = TL.RNNLayer(I, H, num_layers, learn_init_state=True).eval()
    with torch.no_grad():
        for name in ("to_init_state_h", "to_init_state_c"):
            getattr(layer, name).weight.copy_(torch.from_numpy(np.array(j_params[name]["w"]).T.copy()))
            getattr(layer, name).bias.copy_(torch.from_numpy(np.array(j_params[name]["b"])))
        for l, cell in enumerate(j_params["lstm"]["layers"]):
            for k in ("ih", "hh"):
                getattr(layer.lstm, f"weight_{k}_l{l}").copy_(
                    torch.from_numpy(np.array(cell["fwd"][f"w_{k}"]).T.copy()))
                getattr(layer.lstm, f"bias_{k}_l{l}").copy_(torch.from_numpy(np.array(cell["fwd"][f"b_{k}"])))
    x = rng.randn(n, f, I).astype(np.float32)
    j_out, (j_h, j_c) = JL.rnn_layer_apply(j_params, jnp.asarray(x), jnp.asarray(LENGTHS),
                                           num_layers=num_layers, hidden_size=H)
    with torch.no_grad():
        out, (hF, cF) = layer(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(hF.numpy(), np.asarray(j_h), atol=ATOL)
    np.testing.assert_allclose(cF.numpy(), np.asarray(j_c), atol=ATOL)
    # Zero-length row 1: its final state is the learned initial state, with
    # to_init_state_c's output in the h slot.
    c_lin = x[1, 0] @ np.array(j_params["to_init_state_c"]["w"]) + np.array(j_params["to_init_state_c"]["b"])
    np.testing.assert_allclose(hF[:, 1].numpy(), c_lin.reshape(num_layers, H), atol=ATOL)


def test_wrapper_rejects_bad_input_before_launch():
    """CUDA-only checks sit in front of the kernel; a non-CPU, non-CUDA
    tensor is refused rather than run through the plain version."""
    cells, x, mask, h0, c0 = _case(2, seed=5)
    t_cells, tx, tm, th0, tc0 = _torch(cells, x, mask, h0, c0)
    ops = K.stack_operands(t_cells, tx)
    meta = [a.to("meta") for a in (ops[0], tm, ops[1], ops[2], ops[3], th0, tc0)]
    with pytest.raises(ValueError, match="no LSTM stack kernel"):
        K.lstm_stack_fused(*meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LSTM stack kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("num_layers", [1, 2])
def test_kernel_matches_plain_on_card(cuda, num_layers):
    cells, x, mask, h0, c0 = _case(num_layers, seed=11 + num_layers)
    t_cells, tx, tm, th0, tc0 = _torch(cells, x, mask, h0, c0)
    t_cells = [{k: v.to(cuda) for k, v in c.items()} for c in t_cells]
    args = (tx.to(cuda), tm.to(cuda), th0.to(cuda), tc0.to(cuda))
    launches = K.LAUNCHES
    got = K.lstm_stack(t_cells, *args)
    want = K.lstm_stack(t_cells, *args, stack_fn=K.lstm_stack_plain)
    assert K.LAUNCHES == launches + 1
    for a, b in ((got[0], want[0]), (got[1][0], want[1][0]), (got[1][1], want[1][1])):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=ATOL)
