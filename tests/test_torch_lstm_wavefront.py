"""The port's wavefront LSTM stack (plain version of the CUDA kernel) against
the JAX package, and the port's bench tool.

Reference: ``empose_tpu.ops.lstm_kernel.lstm_stack_pallas_wavefront`` in
Pallas interpret mode, and the port's own layer-serial ``lstm_stack_plain``.
Tolerance atol 1e-5: fp32 on both sides, the same op order up to the matmul
summation order; finals at 0-length rows bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empose_tpu.ops.lstm_kernel import lstm_stack_pallas_wavefront

from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.tools import bench_lstm_kernels

torch.set_num_threads(1)
ATOL = 1e-5
F, N, I, H = 7, 3, 5, 16
LENGTHS = np.array([7, 0, 3])  # full, empty, partial


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


@pytest.mark.parametrize("num_layers", [2, 3])
def test_wavefront_matches_pallas_interpret_and_stack(num_layers):
    cells, x, mask, h0, c0 = _case(num_layers, seed=20 + num_layers)
    j_out, (j_h, j_c) = lstm_stack_pallas_wavefront(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in cells], jnp.asarray(x),
        jnp.asarray(mask), jnp.asarray(h0), jnp.asarray(c0), interpret=True)
    t_cells, tx, tm, th0, tc0 = _torch(cells, x, mask, h0, c0)
    launches = K.WAVEFRONT_LAUNCHES
    out, (hF, cF) = K.lstm_stack_wavefront(t_cells, tx, tm, th0, tc0)
    assert K.WAVEFRONT_LAUNCHES == launches  # CPU tensors: the plain version, no launch
    s_out, (s_h, s_c) = K.lstm_stack(t_cells, tx, tm, th0, tc0, K.lstm_stack_plain)
    assert out.shape == (F, N, H) and hF.shape == (num_layers, N, H)
    for got, pallas, stack in ((out, j_out, s_out), (hF, j_h, s_h), (cF, j_c, s_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), stack.numpy(), atol=ATOL)
    # 0-length row: state frozen bit for bit, outputs zero.
    assert np.array_equal(hF[:, 1].numpy(), h0[:, 1]) and np.array_equal(cF[:, 1].numpy(), c0[:, 1])
    assert not out[:, 1].any() and not out[3:, 2].any()


def test_wavefront_needs_two_layers():
    cells, x, mask, h0, c0 = _case(1, seed=30)
    t_cells, tx, tm, th0, tc0 = _torch(cells, x, mask, h0, c0)
    with pytest.raises(ValueError, match=">= 2 layers"):
        K.lstm_stack_wavefront(t_cells, tx, tm, th0, tc0)
    ops = K.stack_operands(t_cells, tx)
    for fn in (K.lstm_stack_wavefront_plain, K.lstm_stack_wavefront_fused):
        with pytest.raises(ValueError, match=">= 2 layers"):
            fn(ops[0], tm, ops[1], ops[2], ops[3], th0, tc0)


def test_wavefront_wrapper_rejects_other_devices():
    cells, x, mask, h0, c0 = _case(2, seed=31)
    t_cells, tx, tm, th0, tc0 = _torch(cells, x, mask, h0, c0)
    ops = K.stack_operands(t_cells, tx)
    meta = [a.to("meta") for a in (ops[0], tm, ops[1], ops[2], ops[3], th0, tc0)]
    with pytest.raises(ValueError, match="no LSTM wavefront kernel"):
        K.lstm_stack_wavefront_fused(*meta)


def test_bench_tool_runs_on_cpu(capsys):
    rows = bench_lstm_kernels.main(["--batch", "1", "3", "--window", "4", "--hidden", "8",
                                    "--input", "6", "--iters", "2", "--repeats", "1",
                                    "--device", "cpu"])
    assert [(n, name) for n, name, *_ in rows] == [
        (n, name) for n in (1, 3) for name in ("scan", "kernel", "wavefront")]
    assert all(ms > 0 and where == "cpu" for _, _, ms, _, where in rows)
    assert "wavefront" in capsys.readouterr().out


def test_bench_tool_refuses_other_precisions_and_missing_cuda():
    with pytest.raises(SystemExit):  # a mode the port does not know
        bench_lstm_kernels.main(["--precision", "bf16", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_lstm_kernels.main(["--batch", "1", "--window", "2", "--hidden", "8"])
