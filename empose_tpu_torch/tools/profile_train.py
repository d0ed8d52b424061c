"""Per-stage timing of the training step (port of ``tools/profile_train.py``).

Attributes a training step of the flagship LGD-RNN-6 (seeded random
weights on the synthetic SMPL-H; ``profile_common.make_train_step``, the
pieces of ``Trainer.train_step``) by timing each stage on its own: the
datagen (the preprocess chain: FK, sensors, offsets, noise), the train
forward + loss, forward + backward (the gradients; the init RNN's training
pair launches its forward sweep per LSTM layer in the forward and its
reverse sweep per layer in the backward), the Adam update alone, and the
whole step.

    python -m empose_tpu_torch.tools.profile_train [--batch 64] [--window 256] [--remat]
        [--device cpu]

Every stage is timed as a chain (``utils/profiling.timeit_chain``): each
call's input depends on the previous call's output, through the parameters
the stage updates or, where there is no such carry, a 1e-30-scaled coupling
(``profile_common.couple``, one elementwise op), so every output is
consumed. The forward keeps autograd on, as the LGD loop needs its
gradient input. The rows carry the JAX tool's names: its "FULL fused step"
is one XLA program there, one eager optimizer step here. Runs on CUDA
unless ``--device cpu``; ``main`` returns the rows (ms, calls) as a dict.
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
from empose_tpu_torch.tools.profile_common import (build_model, couple, device_name,
                                                   flagship_config, in_memory_bank,
                                                   make_train_step, tiny_batch)
from empose_tpu_torch.train.loop import train_loss
from empose_tpu_torch.utils.profiling import chain_calls, timeit_chain

STAGES = ("datagen (preprocess chain)", "forward + loss", "forward + backward (grad)",
          "adam update", "FULL fused step")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.profile_train")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--remat", action="store_true",
                   help="Recompute the FK+sensor blocks in the backward (the trainer's "
                        "--remat flag) to measure its time at this shape.")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    return p


def main(argv: Optional[list] = None, config: Optional[Configuration] = None, iters: int = 20,
         warmup: int = 3, repeats: int = 3) -> Dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    config = Configuration(vars(config if config is not None else flagship_config()))
    config.bs_train, config.window_size = args.batch, args.window
    if args.remat:
        config.remat = True
    depth = dict(iters=iters, warmup=warmup, repeats=repeats)
    calls = chain_calls(**depth)

    with precision_scope("highest"):
        model, sensor = build_model(config, dev)
        step, opt = make_train_step(model, sensor, config)
        params = list(model.parameters())
        batch = to_device(tiny_batch(np.random.RandomState(0), n=args.batch, f=args.window), dev)
        generator = torch.Generator(dev).manual_seed(7)
        pre = T.make_preprocess_fn(sensor, in_memory_bank(device=dev), config,
                                   randomize_if_configured=True)
        model.train()

        # --- datagen: the preprocess chain; the next call's batch takes this
        # call's first marker position (x 1e-30).
        def pre_step(b):
            gen = pre(b, generator, mode="all")
            return couple(b, gen["marker_pos"].reshape(-1)[0])
        t_pre = timeit_chain(pre_step, {k: v.clone() for k, v in batch.items()}, **depth)

        gen = pre(batch, torch.Generator(dev).manual_seed(8), mode="all")
        model_gen = torch.Generator(dev).manual_seed(9)

        # --- forward + loss (the graph is built and dropped)
        def fwd_step(ps):
            out, _ = model(gen, None, model_gen)
            total, _ = model.compute_loss(gen, out)
            return couple(ps, total)
        t_fwd = timeit_chain(fwd_step, params, **depth)

        # --- forward + backward (the gradients of the train loss)
        def grad_step(ps):
            loss, _ = train_loss(model, gen, model_gen)
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                torch._foreach_add_(ps, grads, alpha=-1e-30)
            return ps
        t_grad = timeit_chain(grad_step, params, **depth)

        # --- Adam alone, on one set of gradients (natural carry: the state)
        loss, _ = train_loss(model, gen, model_gen)
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        del loss

        def adam_step(ps):
            opt.step()
            return ps
        t_adam = timeit_chain(adam_step, params, **depth)

        # --- the whole step (natural carry: the train state)
        def full_step(ps):
            step(batch, generator)
            return ps
        t_step = timeit_chain(full_step, params, **depth)

    n_frames = args.batch * args.window
    times = dict(zip(STAGES, (t_pre, t_fwd, t_grad, t_adam, t_step)))
    rows = {name: {"ms": ms, "calls": calls} for name, ms in times.items()}
    rows["forward + backward (grad)"]["backward_ms"] = t_grad - t_fwd
    # The gradients Adam applies took one forward + backward outside the chain.
    rows["adam update"]["grad_calls"] = 1
    rows["FULL fused step"]["frames_per_s"] = n_frames / t_step * 1e3
    rows["sum of isolated stages"] = {"ms": t_pre + t_grad + t_adam}
    print(f"batch {args.batch} x window {args.window} ({n_frames} frames) on {device_name(dev)}"
          + (", --remat" if args.remat else ""))
    print(f"  datagen (preprocess chain)   {t_pre:7.2f} ms")
    print(f"  forward + loss               {t_fwd:7.2f} ms")
    print(f"  forward + backward (grad)    {t_grad:7.2f} ms   (backward ~= {t_grad - t_fwd:.2f})")
    print(f"  adam update                  {t_adam:7.2f} ms")
    print(f"  FULL fused step              {t_step:7.2f} ms   "
          f"({n_frames / t_step * 1e3:,.0f} frames/s)")
    print(f"  sum of isolated stages       {t_pre + t_grad + t_adam:7.2f} ms")
    return rows


if __name__ == "__main__":
    main()
