"""Component-level backward attribution of the training step (port of
``tools/profile_backward.py``).

``profile_train`` splits the step into datagen, forward, backward and
Adam; this tool splits the backward further, timing each component's
forward and forward + gradient at the training shapes, so the gradient's
cost falls out by subtraction:

  * FK + sensor synthesis with the offsets, ``SensorSMPL.estimated_markers``
    (``markers_and_joints`` and the offset apply): the counterpart of the
    JAX tool's lane-major FK (``ops/fk_lanes.py``), a TPU layout of the same
    function; the row keeps the JAX name. The LGD loop calls it N+1 times
    a step, and its gradient N+1 times;
  * the init RNN in training mode: the training pair, one forward sweep per
    LSTM layer and, with the gradient, one reverse sweep per layer;
  * the iter-MLP pair, the two MLP modules the model runs one after the
    other (the loop runs them N times);
  * the full model, for reference.

Each row is a chain (``utils/profiling.timeit_chain``, imported through
``profile_train`` as the JAX tool imports it, the same harness) and, where a count can be had, its GFLOP and TFLOP/s:
the aten products that ``FlopCounterMode`` counts plus the LSTM kernels'
products by hand (``profile_common.count_flops``).

    python -m empose_tpu_torch.tools.profile_backward [--batch 64] [--window 256]
        [--precision highest|high|default] [--device cpu]

``--precision`` binds the NN knob (``nn/layers.set_nn_precision``) and the
kinematics knob (``nn/models.set_fk_precision``) for the run and restores
both after. Runs on CUDA unless ``--device cpu``; ``main`` returns the rows
(ms, calls, GFLOP) as a dict.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data import transforms as T
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.device import precision_scope, resolve_device
from empose_tpu_torch.tools.profile_common import (build_model, count_flops, couple, device_name,
                                                   flagship_config, in_memory_bank,
                                                   lstm_flops_per_launch, tiny_batch)
from empose_tpu_torch.tools.profile_train import timeit_chain
from empose_tpu_torch.train.loop import train_loss
from empose_tpu_torch.utils.profiling import chain_calls

ROWS = ("lane FK+sensors fwd (x1)", "lane FK+sensors fwd+grad (x1)", "init LSTM fwd",
        "init LSTM fwd+grad", "iter MLP pair fwd (x1)", "iter MLP pair fwd+grad (x1)",
        "FULL model fwd+loss", "FULL model fwd+grad")


def fk_scalar(sensor, pose, shape, offset_r, offset_t) -> torch.Tensor:
    """sum(mp^2) + sum(mo) + sum(j^2) of one FK + sensor pass with offsets."""
    mp, mo, j = sensor.estimated_markers(pose, shape, offset_r, offset_t)
    return (mp * mp).sum() + mo.sum() + (j * j).sum()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.profile_backward")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--precision", default="highest", choices=("highest", "high", "default"),
                   help="NN/FK matmul precision (the trainer's --matmul_precision).")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    return p


def _descend(ps, grads) -> list:
    """``p -= 1e-30 * g`` in place: the next call depends on these gradients."""
    with torch.no_grad():
        torch._foreach_add_(ps, list(grads), alpha=-1e-30)
    return ps


def main(argv: Optional[list] = None, config: Optional[Configuration] = None, iters: int = 20,
         warmup: int = 3, repeats: int = 3) -> Dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    config = Configuration(vars(config if config is not None else flagship_config()))
    n, f = args.batch, args.window
    config.bs_train, config.window_size = n, f
    nf = n * f
    depth = dict(iters=iters, warmup=warmup, repeats=repeats)
    per_launch = lstm_flops_per_launch(f, n, config.m_rnn_hidden_size, config.m_rnn_num_layers)
    rows = {}

    def timed(name, fn, carry):
        ms = timeit_chain(fn, carry, **depth)
        flops = count_flops(fn, carry, per_launch=per_launch)
        rows[name] = {"ms": ms, "calls": chain_calls(**depth) + 1, "flops": flops}

    with precision_scope(args.precision):
        model, sensor = build_model(config, dev)
        model.train()
        rng = np.random.RandomState(0)

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        # ---- FK + sensors (the LGD loop's inner function) ----------------
        pose0 = tensor(rng.randn(nf, 66) * 0.2)
        shape0 = tensor(rng.randn(nf, 10) * 0.2)
        orr = tensor(np.broadcast_to(np.eye(3), (nf, 12, 3, 3)))
        ott = tensor(rng.randn(nf, 12, 3) * 0.02)

        def fk_fwd(ps):
            with torch.no_grad():
                return couple(ps, fk_scalar(sensor, ps[0], shape0, orr, ott))
        timed(ROWS[0], fk_fwd, [pose0.clone()])

        def fk_grad(ps):
            p = ps[0].detach().requires_grad_()
            return _descend(ps, torch.autograd.grad(fk_scalar(sensor, p, shape0, orr, ott), p))
        timed(ROWS[1], fk_grad, [pose0.clone()])

        # ---- init LSTM, training mode: the training pair ------------------
        x = tensor(rng.randn(n, f, model.input_size))
        lengths = torch.full((n,), f, dtype=torch.int64, device=dev)

        def lstm(xx):
            return model.rnn(xx, lengths)[0]

        def lstm_fwd(xs):
            with torch.no_grad():
                return couple(xs, lstm(xs[0]).sum())
        timed(ROWS[2], lstm_fwd, [x.clone()])

        rnn_params = list(model.rnn.parameters())

        def lstm_grad(ps):
            return _descend(ps, torch.autograd.grad(lstm(x).sum(), ps))
        timed(ROWS[3], lstm_grad, rnn_params)

        # ---- the iter-MLP pair (x1; the loop runs it N times) -------------
        xi = tensor(rng.randn(nf, model.input_iter_size))
        bn_mask = torch.ones(nf, device=dev)

        def mlps(xx):
            return model.pose_net_iter(xx, bn_mask).sum() + model.shape_net_iter(xx, bn_mask).sum()

        def mlp_fwd(xs):
            with torch.no_grad():
                return couple(xs, mlps(xs[0]))
        timed(ROWS[4], mlp_fwd, [xi.clone()])

        mlp_params = list(model.pose_net_iter.parameters()) + list(
            model.shape_net_iter.parameters())

        def mlp_grad(ps):
            return _descend(ps, torch.autograd.grad(mlps(xi), ps))
        timed(ROWS[5], mlp_grad, mlp_params)

        # ---- the full model (context) -------------------------------------
        batch = to_device(tiny_batch(rng, n=n, f=f), dev)
        pre = T.make_preprocess_fn(sensor, in_memory_bank(device=dev), config,
                                   randomize_if_configured=True)
        gen = pre(batch, torch.Generator(dev).manual_seed(3), mode="all")
        model_gen = torch.Generator(dev).manual_seed(4)
        params = list(model.parameters())

        def full_loss():
            return train_loss(model, gen, model_gen)[0]

        def full_fwd(ps):
            return couple(ps, full_loss())
        timed(ROWS[6], full_fwd, params)

        def full_grad(ps):
            return _descend(ps, torch.autograd.grad(full_loss(), ps))
        timed(ROWS[7], full_grad, params)

    print(f"batch {n} x window {f} ({nf} frames), N={config.m_num_iterations} "
          f"LGD iterations, precision={args.precision} on {device_name(dev)}")
    for name in ROWS:
        row = rows[name]
        flops = row.pop("flops")
        eff = ""
        if flops:
            row.update(gflop=flops.total / 1e9, gflop_counted=flops.counted / 1e9,
                       gflop_by_hand=flops.by_hand / 1e9,
                       tflops=flops.total / (row["ms"] * 1e9))
            eff = (f"  {row['gflop']:7.1f} GFLOP  {row['tflops']:6.2f} TFLOP/s  "
                   f"({row['gflop_counted']:.1f} counted by FlopCounterMode + "
                   f"{row['gflop_by_hand']:.1f} LSTM kernels by hand)")
        print(f"  {name:34s} {row['ms']:8.2f} ms{eff}")
    return rows


if __name__ == "__main__":
    main()
