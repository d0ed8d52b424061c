"""Least times of the port's kernels on one NVIDIA H100 SXM, and the
card's peaks (the data sheet's dense rates at the 700 W limit).

A kernel's least time is the larger of its operations over the peak of its
precision (fp32 outside the tensor cores at ``highest``) and its bytes over
the memory rate, counting every input read once and every output written
once. The operations are the LSTM's multiply-adds, 2 FLOPs each:
- the stack of L layers (layer 0's input product is outside it),
  2·F·N·H·4H·(2L−1);
- each training sweep of one direction-layer, 2·F·N·H·4H.
"""

from __future__ import annotations

FP32_PEAK = 67e12      # FLOP/s, fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12  # bytes/s


def bound_s(flops: float, n_bytes: float) -> float:
    return max(flops / FP32_PEAK, n_bytes / HBM_BYTES_S)


def stack_s(f: int, n: int, h: int, layers: int) -> float:
    """The inference stack (``csrc/lstm_stack.cu``) at F steps, N rows."""
    h4 = 4 * h
    flops = 2.0 * f * n * h * h4 * (2 * layers - 1)
    n_bytes = 4.0 * (f * n * h4 + f * n                            # x0_proj, mask
                     + (2 * layers - 1) * h * h4 + (layers - 1) * h4  # weights, biases
                     + 2 * layers * n * h                           # h0, c0
                     + f * n * h + 2 * layers * n * h)              # outs, hF, cF
    return bound_s(flops, n_bytes)


def train_fwd_s(f: int, n: int, h: int) -> float:
    """The training forward sweep (``csrc/lstm_train.cu``)."""
    h4 = 4 * h
    n_bytes = 4.0 * (f * n * h4 + f * n + h * h4 + 2 * n * h      # x_proj, mask, W_hh, h0/c0
                     + f * n * h4 + 2 * f * n * h)                # gates, h_all, c_all
    return bound_s(2.0 * f * n * h * h4, n_bytes)


def train_bwd_s(f: int, n: int, h: int) -> float:
    """The training reverse sweep (``csrc/lstm_train.cu``)."""
    h4 = 4 * h
    n_bytes = 4.0 * (3 * f * n * h + f * n * h4 + f * n + h * h4  # dh, dc, c_prev, gates, mask, W
                     + f * n * h4 + 2 * n * h)                    # dgates, dh0, dc0
    return bound_s(2.0 * f * n * h * h4, n_bytes)
