"""The differentiable LSTM direction-layer: the CUDA training pair, its plain
versions, the autograd function that ties them together, and their counts.

The kernels (``csrc/lstm_train.cu``) replace the Pallas TPU kernels of
``empose_tpu/ops/lstm_train_kernel.py``: ``_pallas_fwd`` (the forward sweep
with W_hh resident, emitting the gate pre-activations and the carried h and
c of every step) and ``_pallas_bwd`` (the reverse-time sweep emitting dgates
and carrying dh, dc into dh0, dc0). The source file says what bounds them on
an H100 and how W_hh is spread over the SMs.

The decomposition is the JAX package's: only the serial recurrence runs in
the kernels; the input projection ``x @ W_ih + b_ih + b_hh``, ``outs =
h_all * mask``, the final states, ``dW_hh = h_prev^T @ dgates`` and
``dx_proj = dgates`` are plain torch around them.

Contracts (time-major, the JAX kernels' layouts; ``mask`` is (F, N), 1.0 at
valid steps):

* forward ``(x_proj (F, N, 4H), mask, w_hh (H, 4H), h0, c0 (N, H)) ->
  (gates (F, N, 4H) or None, h_all (F, N, H), c_all (F, N, H))``: ``h_all[t]``
  and ``c_all[t]`` are the carried state after step t, frozen (selected, not
  blended) where the mask is 0;
* backward ``(dh_all, dc_all (F, N, H), gates, c_prev (F, N, H), mask, w_hh)
  -> (dgates (F, N, 4H), dh0, dc0 (N, H))``: ``c_prev[t]`` is the cell state
  before step t; frozen steps give zero dgates and pass dh, dc through.

``lstm_train_fwd``/``lstm_train_bwd`` launch the kernels for CUDA tensors
and run the plain versions for CPU tensors; ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from empose_tpu_torch.ops import cuda_build
from empose_tpu_torch.ops.lstm_kernel import _check, _sigmoid_tanh_cell

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

NAME = "lstm_train"  # csrc/lstm_train.cu


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(NAME, {
        "lstm_train_forward": ([p, p, p, p, p, p, p, p, i, i, i, p], i),
        "lstm_train_backward": ([p, p, p, p, p, p, p, p, p, i, i, i, p], i),
    })


def lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, save_gates: bool = True):
    """The forward sweep step by step in plain torch (see module doc)."""
    h, c = h0, c0
    gates_all, hs, cs = [], [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t] + h @ w_hh
        h_new, c_new = _sigmoid_tanh_cell(gates, c)
        m = mask[t][:, None]
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        gates_all.append(gates)
        hs.append(h)
        cs.append(c)
    return (torch.stack(gates_all) if save_gates else None), torch.stack(hs), torch.stack(cs)


def lstm_train_bwd_plain(dh_all, dc_all, gates, c_prev, mask, w_hh):
    """The reverse sweep step by step in plain torch, the formulas of
    ``empose_tpu/ops/lstm_train_kernel.py::_make_bwd_kernel`` (see module doc)."""
    dh = torch.zeros_like(dh_all[0])
    dc = torch.zeros_like(dc_all[0])
    dgates = torch.empty_like(gates)
    for t in range(gates.shape[0] - 1, -1, -1):
        m = mask[t][:, None]
        Dh = dh + dh_all[t]
        Dc = dc + dc_all[t]
        gi, gf, gg, go = gates[t].chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        cp = c_prev[t]
        tc = torch.tanh(f * cp + i * g)
        dh_new = Dh * m
        dc_new = Dc * m + dh_new * o * (1.0 - tc * tc)
        dgates[t] = torch.cat([dc_new * g * i * (1.0 - i), dc_new * cp * f * (1.0 - f),
                               dc_new * i * (1.0 - g * g), dh_new * tc * o * (1.0 - o)], dim=-1)
        dh = dgates[t] @ w_hh.t() + Dh * (1.0 - m)
        dc = dc_new * f + Dc * (1.0 - m)
    return dgates, dh, dc


def lstm_train_fwd(x_proj, mask, w_hh, h0, c0, save_gates: bool = True):
    """The forward sweep: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global FWD_LAUNCHES
    if x_proj.device.type == "cpu":
        return lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, save_gates)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no LSTM training kernel for device {x_proj.device}")
    f, n, _ = x_proj.shape
    hidden = w_hh.shape[0]
    dev = x_proj.device
    _check("x_proj", x_proj, (f, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh", w_hh, (hidden, 4 * hidden), dev)
    _check("h0", h0, (n, hidden), dev)
    _check("c0", c0, (n, hidden), dev)
    lib = _library()
    gates = torch.empty(f, n, 4 * hidden, device=dev) if save_gates else None
    h_all = torch.empty(f, n, hidden, device=dev)
    c_all = torch.empty(f, n, hidden, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lstm_train_forward(
            x_proj.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            gates.data_ptr() if save_gates else None, h_all.data_ptr(), c_all.data_ptr(),
            f, n, hidden, stream)
    cuda_build.check(code, "LSTM training forward kernel")
    FWD_LAUNCHES += 1
    return gates, h_all, c_all


def lstm_train_bwd(dh_all, dc_all, gates, c_prev, mask, w_hh):
    """The reverse sweep: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global BWD_LAUNCHES
    if gates.device.type == "cpu":
        return lstm_train_bwd_plain(dh_all, dc_all, gates, c_prev, mask, w_hh)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM training kernel for device {gates.device}")
    f, n, _ = gates.shape
    hidden = w_hh.shape[0]
    dev = gates.device
    for name, t in (("dh_all", dh_all), ("dc_all", dc_all), ("c_prev", c_prev)):
        _check(name, t, (f, n, hidden), dev)
    _check("gates", gates, (f, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh", w_hh, (hidden, 4 * hidden), dev)
    lib = _library()
    dgates = torch.empty_like(gates)
    dh0 = torch.empty(n, hidden, device=dev)
    dc0 = torch.empty(n, hidden, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lstm_train_backward(
            dh_all.data_ptr(), dc_all.data_ptr(), gates.data_ptr(), c_prev.data_ptr(),
            mask.data_ptr(), w_hh.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), f, n, hidden, stream)
    cuda_build.check(code, "LSTM training backward kernel")
    BWD_LAUNCHES += 1
    return dgates, dh0, dc0


class LSTMCore(torch.autograd.Function):
    """``(x_proj, mask, w_hh, h0, c0) -> (h_all, c_all)`` through a forward and
    a backward sweep (``_lstm_core`` with its custom VJP in the JAX package).

    Saves ``gates``, ``h_prev`` and ``c_prev`` (the state before every step);
    the backward returns ``dx_proj = dgates``, ``dW_hh = h_prev^T @ dgates``,
    ``dh0`` and ``dc0``, and none for the mask."""

    @staticmethod
    def forward(ctx, x_proj, mask, w_hh, h0, c0, fwd, bwd):
        gates, h_all, c_all = fwd(x_proj, mask, w_hh, h0, c0, True)
        h_prev = torch.cat([h0[None], h_all[:-1]])
        c_prev = torch.cat([c0[None], c_all[:-1]])
        ctx.save_for_backward(gates, h_prev, c_prev, mask, w_hh)
        ctx.bwd = bwd
        return h_all, c_all

    @staticmethod
    def backward(ctx, dh_all: Optional[torch.Tensor], dc_all: Optional[torch.Tensor]):
        gates, h_prev, c_prev, mask, w_hh = ctx.saved_tensors
        zeros = torch.zeros_like(c_prev)
        dh_all = zeros if dh_all is None else dh_all.contiguous()
        dc_all = zeros if dc_all is None else dc_all.contiguous()
        dgates, dh0, dc0 = ctx.bwd(dh_all, dc_all, gates, c_prev, mask, w_hh)
        hidden = w_hh.shape[0]
        dw_hh = h_prev.reshape(-1, hidden).t() @ dgates.reshape(-1, 4 * hidden)
        return dgates, None, dw_hh, dh0, dc0, None, None


def lstm_cell_train(cell: dict, x: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor, fwd=lstm_train_fwd, bwd=lstm_train_bwd):
    """Differentiable drop-in for ``empose_tpu/ops/lstm_train_kernel.py::
    lstm_cell_train_pallas``: one LSTM direction-layer over time, state frozen
    at masked steps; gradients flow to the cell's weights, ``x``, ``h0`` and
    ``c0``. ``fwd``/``bwd`` are the sweeps (a reference run on the card may
    pass the plain versions).

    :param cell: w_ih (I, 4H), w_hh (H, 4H), b_ih, b_hh (4H,).
    :param x: (F, N, I); :param mask: (F, N).
    :return: (outputs (F, N, H) zeroed at masked steps, (hF, cF)).
    """
    x_proj = (x @ cell["w_ih"] + cell["b_ih"] + cell["b_hh"]).contiguous()
    w_hh = cell["w_hh"].contiguous()
    mask = mask.contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, w_hh, h0, c0)):
        h_all, c_all = LSTMCore.apply(x_proj, mask, w_hh, h0, c0, fwd, bwd)
    else:
        # The undifferentiated primal: no gate pre-activations are kept.
        _, h_all, c_all = fwd(x_proj, mask, w_hh, h0, c0, False)
    outs = h_all * mask[:, :, None]
    return outs, (h_all[-1], c_all[-1])
