"""Per-component timing of the LGD-RNN-6 forward at inference (port of
``tools/profile_forward.py``).

Times each piece of the eval-mode forward of the released LGD-RNN-6
(``profile_common.bench_config``, seeded random weights on the synthetic
SMPL-H) on its own, so the forward's time is attributable: the init RNN
with its heads (the stack kernel, one launch per call where the whole 2x512
stack fits the card), one FK + sensor pass, the reconstruction error's
value and gradient (``IterativeErrorFeedback._recon_error`` through
``torch.autograd.grad``), the iter-MLP pair and the full forward.

    python -m empose_tpu_torch.tools.profile_forward [--batch 8] [--window 256] [--device cpu]

The port has one form of the iter-MLP pair, the two MLP modules the model
runs one after the other, so the JAX tool's "unfused" line reports that
instead of a second time. Each piece's time is the best of ``repeats``
blocks (``utils/profiling.timeit_ms``). Runs on CUDA unless ``--device
cpu``; ``main`` returns the rows (ms, calls) as a dict.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.device import precision_scope, resolve_device
from empose_tpu_torch.tools.profile_common import (bench_config, build_model, device_name,
                                                   make_window)
from empose_tpu_torch.utils.profiling import chain_calls, timeit_ms

UNFUSED = ("the port has one form of the pair (the two MLP modules, as the model runs them): "
           "the line above")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.profile_forward")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    return p


def main(argv: Optional[list] = None, config: Optional[Configuration] = None, iters: int = 20,
         warmup: int = 3, repeats: int = 3) -> Dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    n, f = args.batch, args.window
    nf = n * f
    depth = dict(iters=iters, warmup=warmup, repeats=repeats)
    calls = chain_calls(**depth)
    rows = {}

    def timed(name, fn, *fn_args):
        rows[name] = {"ms": timeit_ms(fn, *fn_args, **depth), "calls": calls}
        return rows[name]["ms"]

    with precision_scope("highest"), torch.no_grad():
        model, sensor = build_model(config if config is not None else bench_config(), dev)
        rng = np.random.RandomState(0)
        w = to_device(make_window(rng, n, f), dev)
        x = model.prepare_inputs(w)

        def full(w):
            out, carry = model(w, None)
            return out["pose_hat"], out["root_ori_hat"], out["shape_hat"], out["joints_hat"], carry
        t_full = timed("full forward", full, w)

        def init_rnn(x, lengths):
            lstm_out, carry = model.rnn(x, lengths)
            return model.pose_net_init(lstm_out), model.shape_net_init(lstm_out), carry
        t_rnn = timed("init RNN + heads", init_rnn, x, w["seq_lengths"])

        offset_r, offset_t = model._offsets_flat(w, n, f)
        pose0 = torch.from_numpy(rng.randn(nf, 66).astype(np.float32) * 0.2).to(dev)
        shape0 = torch.from_numpy(rng.randn(nf, 10).astype(np.float32) * 0.2).to(dev)

        def fk(pose, shape):
            return sensor.estimated_markers(pose, shape, offset_r, offset_t)
        t_fk = timed("FK+sensor (1 eval)", fk, pose0, shape0)

        inputs_flat = x.reshape(nf, -1)

        def recon_value_and_grad(pose, shape):
            with torch.enable_grad():
                pose, shape = pose.detach().requires_grad_(), shape.detach().requires_grad_()
                mp, mo, _ = fk(pose, shape)
                err = model._recon_error(inputs_flat, mp, mo, n, f, w["seq_lengths"], None)
                return (err.detach(),) + torch.autograd.grad(err, (pose, shape))
        t_vg = timed("recon val+grad", recon_value_and_grad, pose0, shape0)

        iter_in = torch.from_numpy(
            rng.randn(nf, model.input_iter_size).astype(np.float32)).to(dev)

        def iter_pair(iter_in):
            return model.pose_net_iter(iter_in), model.shape_net_iter(iter_in)
        t_iter = timed("iter-MLP pair", iter_pair, iter_in)

    N = model.N
    accounted = t_rnn + N * (t_vg + t_iter) + t_fk
    rows["full forward"]["frames_per_s"] = nf / t_full * 1e3
    rows["iter-MLP unfused"] = {"ms": None, "note": UNFUSED}
    rows["sum of parts"] = {"ms": accounted}
    print(f"batch={n} window={f} (frames/call={nf}) on {device_name(dev)}")
    print(f"full forward        : {t_full:8.3f} ms   ({nf / t_full * 1e3:,.0f} frames/s)")
    print(f"init RNN + heads    : {t_rnn:8.3f} ms   ({t_rnn / t_full * 100:5.1f}%)")
    print(f"FK+sensor (1 eval)  : {t_fk:8.3f} ms   ({t_fk / t_full * 100:5.1f}%)")
    print(f"recon val+grad (x{N}) : {t_vg:8.3f} ms   ({N * t_vg / t_full * 100:5.1f}%)")
    print(f"iter-MLP pair  (x{N}) : {t_iter:8.3f} ms   ({N * t_iter / t_full * 100:5.1f}%)")
    print(f"iter-MLP unfused    : {UNFUSED}")
    print(f"sum of parts        : {accounted:8.3f} ms   vs full {t_full:8.3f} ms")
    return rows


if __name__ == "__main__":
    main()
