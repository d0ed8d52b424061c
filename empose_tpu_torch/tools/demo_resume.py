"""Checkpoint/resume demo on the flagship LGD model: prove seamless resume
across an eval pass (port of ``tools/demo_resume.py``).

Runs the released LGD-RNN-6 retrain config (reference README.md:210-228:
batch 12, window 32, N=2 gradient iterations) through a full
eval -> checkpoint -> restore cycle:

  phase A: train to step K, run the validation and the test pass, save the
           full train state (parameters, BatchNorm statistics, Adam moments,
           the generator, the counters);
  phase B: a trainer of another seed restores it and continues to 2K;
  control: an uninterrupted 2K-step run over the same batch order.

Seamless: the post-resume losses equal the uninterrupted run's step for
step, though an eval pass lay between phase A's steps and its save. Also
prints the wall clock of a train step, the validation pass and the test
pass, and, last, one JSON line of the readings. Exits 1 where the
post-resume difference reaches 1e-4.

    python -m empose_tpu_torch.tools.demo_resume [--k 60] [--assets DIR] [--device cpu]

``--assets`` defaults to ``resume_assets`` in the temporary directory and
is written there (``make_synthetic_assets``) where it is missing. Runs on
CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from empose_tpu_torch.data.batches import collate_amass
from empose_tpu_torch.data.datasets import (EMRBatchLoader, EMRSequenceDataset, Loader,
                                            make_real_loader)
from empose_tpu_torch.eval.metrics import MetricsEngine
from empose_tpu_torch.tools.gate_common import (asset_env, default_assets, fixed_batches,
                                                held_out_mpjpe, lgd_retrain_config, run_fixed,
                                                time_stats)
from empose_tpu_torch.train.loop import Trainer

RESUME_TOL = 1e-4


def main(argv: Optional[list] = None) -> int:
    """Run the demo; 0 where the resume is seamless, else 1."""
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.demo_resume")
    p.add_argument("--k", type=int, default=60, help="Steps of each phase.")
    p.add_argument("--assets", default=None,
                   help="The asset tree (default: resume_assets in the temporary directory; "
                        "written where it is missing).")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default) or cpu.")
    args = p.parse_args(argv)
    with asset_env(args.assets or default_assets("resume_assets"), args.device) as d:
        result = run_demo(args.k, d, args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


def run_demo(k: int, d: str, device) -> dict:
    cfg = lgd_retrain_config()
    ckpt = os.path.join(d, "resume_ckpt")
    # The batch order all runs share.
    batches = fixed_batches(EMRBatchLoader(os.path.join(d, "data_synth", "amass_emr"),
                                           cfg.bs_train, cfg.window_size, shuffle=True, seed=7,
                                           pad_multiple=32), 2 * k)
    valid_loader = Loader(EMRSequenceDataset(os.path.join(d, "data_synth", "3dpw_emr"),
                                             window_size=cfg.window_size, window_mode="middle"),
                          6, collate_amass, shuffle=False)

    # ---- Phase A: train K steps, eval, checkpoint. --------------------------
    print(f"phase A: 0 -> {k}", flush=True)
    t_a = Trainer(cfg, seed=17, device=device)
    losses_a, t_steps = [], []
    for _ in range(k):
        t0 = time.time()
        losses_a += run_fixed(t_a, batches, 1)  # reads the loss back: the step is done
        if t_a.global_step > 1:
            t_steps.append(time.time() - t0)
    metrics_engine = MetricsEngine(t_a.smplh, t_a.device)
    t0 = time.time()
    t_a.evaluate_valid(valid_loader, metrics_engine)
    t_valid = time.time() - t0
    t0 = time.time()
    mpjpe_mid = held_out_mpjpe(t_a, metrics_engine, make_real_loader(), 256)
    t_test = time.time() - t0
    t_a.save(ckpt)

    # ---- Phase B: a trainer of another seed restores and continues to 2K. ---
    print(f"phase B: restore -> {2 * k}", flush=True)
    t_b = Trainer(cfg, seed=999, device=device)  # everything must come from the checkpoint
    t_b.restore(ckpt)
    if t_b.global_step != k:
        raise RuntimeError(f"the restored trainer is at step {t_b.global_step}, not {k}")
    losses_b = run_fixed(t_b, batches, k)

    # ---- Control: uninterrupted 2K steps, the same batch order. -------------
    print("control: uninterrupted", flush=True)
    losses_c = run_fixed(Trainer(cfg, seed=17, device=device), batches, 2 * k)

    pre = float(np.abs(np.asarray(losses_a) - np.asarray(losses_c[:k])).max())
    post = float(np.abs(np.asarray(losses_b) - np.asarray(losses_c[k:])).max())
    stats = time_stats(t_steps)
    print(f"\nmax |loss diff| vs uninterrupted: pre-checkpoint {pre:.2e}, post-resume {post:.2e}")
    if stats["n"]:
        print(f"train-step wall clock: mean {stats['mean']:.3f}s  median {stats['median']:.3f}s "
              "(reference example 0.700s, README.md:230)")
    print(f"valid pass: {t_valid:.3f}s   test pass: {t_test:.3f}s "
          "(reference example 3.117s / 73.173s on its real datasets)")
    print(f"held-out MPJPE at step {k}: {mpjpe_mid:.2f} mm")
    print(f"loss at step 1 / {k} / {2 * k}: {losses_c[0]:.4f} / {losses_c[k - 1]:.4f} / "
          f"{losses_c[-1]:.4f}")
    ok = post < RESUME_TOL
    print("RESUME SEAMLESS" if ok else "RESUME DIVERGED", flush=True)
    return {"k": k, "pre_checkpoint_max_loss_diff": pre, "post_resume_max_loss_diff": post,
            "step_s": stats, "valid_pass_s": t_valid, "test_pass_s": t_test,
            "mpjpe_mid_mm": mpjpe_mid, "ok": ok}


if __name__ == "__main__":
    sys.exit(main())
