"""Micro-benchmark of the unidirectional LSTM stack paths on the card.

Port of ``tools/bench_lstm_kernels.py``. For the released init-RNN shape
(2x512 stack) at a given batch and window it times:
  scan       the plain version, layer by layer (``lstm_stack_plain``)
  kernel     the stack kernel, one (step, layer) per grid barrier
  wavefront  the wavefront kernel, layer l at time t - l, F + L - 1 barriers

    python -m empose_tpu_torch.tools.bench_lstm_kernels [--batch 8 64] [--window 256]
        [--hidden 512] [--layers 2] [--input 144] [--iters 20] [--repeats 5]
        [--precision highest|high|default] [--device cuda|cpu]

Each call chains through the previous call's final state (the streaming
pattern); a row is the best of ``--repeats`` runs of ``--iters`` calls,
synchronized, and names the device it ran on. Every path runs its products
at ``--precision`` (the kernels on the tensor cores at ``high`` and
``default``); the knobs are restored when the bench ends.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from empose_tpu_torch.device import precision_scope, resolve_device
from empose_tpu_torch.ops import lstm_kernel as K


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.bench_lstm_kernels")
    p.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--input", type=int, default=144)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--precision", default="highest", choices=("highest", "high", "default"),
                   help="matmul precision of every path: 'highest' = fp32 (TF32 off), 'high' = "
                        "3-pass bf16, 'default' = bf16 inputs")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _cells(n_in: int, hidden: int, layers: int, device) -> list:
    """Seeded uniform(-1/sqrt(H), 1/sqrt(H)) weights, torch's LSTM init."""
    rng = np.random.RandomState(0)
    b = hidden ** -0.5
    u = lambda *s: torch.as_tensor(rng.uniform(-b, b, s).astype(np.float32), device=device)
    return [dict(w_ih=u(n_in if l == 0 else hidden, 4 * hidden), w_hh=u(hidden, 4 * hidden),
                 b_ih=u(4 * hidden), b_hh=u(4 * hidden)) for l in range(layers)]


def main(argv=None) -> list:
    """Run the bench; returns rows of (batch, impl, ms per call, frames/s, device name)."""
    args = parser().parse_args(argv)
    with precision_scope(args.precision):
        return _bench(args)


def _bench(args) -> list:
    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    f, h, nl, prec = args.window, args.hidden, args.layers, args.precision
    cells = _cells(args.input, h, nl, device)
    impls = {
        "scan": lambda x, m, h0, c0: K.lstm_stack(cells, x, m, h0, c0, K.lstm_stack_plain, prec),
        "kernel": lambda x, m, h0, c0: K.lstm_stack(cells, x, m, h0, c0, precision=prec),
        "wavefront": lambda x, m, h0, c0: K.lstm_stack_wavefront(cells, x, m, h0, c0,
                                                                 precision=prec),
    }
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows = []
    with torch.no_grad():
        for n in args.batch:
            rng = np.random.RandomState(0)
            x = torch.as_tensor(rng.randn(f, n, args.input).astype(np.float32), device=device)
            mask = torch.ones(f, n, device=device)
            zeros = torch.zeros(nl, n, h, device=device)
            print(f"batch={n} window={f} stack={nl}x{h} precision={prec} on {where}", flush=True)
            for name, fn in impls.items():
                _, state = fn(x, mask, zeros, zeros)
                sync()
                best = float("inf")
                for _ in range(args.repeats):
                    start = time.perf_counter()
                    for _ in range(args.iters):
                        _, state = fn(x, mask, *state)
                    sync()
                    best = min(best, time.perf_counter() - start)
                ms = best / args.iters * 1e3
                rows.append((n, name, ms, n * f / ms * 1e3, where))
                print(f"  {name:10s} {ms:8.3f} ms/call   {n * f / ms * 1e3:12.0f} frames/s"
                      f"   ({where})", flush=True)
    return rows


if __name__ == "__main__":
    main()
