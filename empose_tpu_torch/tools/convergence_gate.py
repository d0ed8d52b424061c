"""Recorded convergence + resume gate for the flagship LGD model (port of
``tools/convergence_gate.py``).

Fails (exit 1) on training-dynamics regressions, not just numerics:

  1. convergence: train the released LGD-RNN-6 retrain config (reference
     README.md:210-228) for ``--steps`` steps on the deterministic synthetic
     corpus and require the held-out MPJPE to start above
     ``MPJPE_START_MIN`` and end below ``MPJPE_END_MAX``, and the loss to fall;
  2. resume: save a trainer mid-run (the full train state), restore it into
     a trainer of another seed, and require the post-resume losses to equal
     an uninterrupted control run's step for step (within ``RESUME_TOL``);
  3. wall clock: the mean s/step from step 3 on, with the median and the
     quartiles on a line of their own.

The thresholds describe the corpus and the model, not a device. The trained
model is kept as experiment 920000 (920001 at ``high``, 920002 at
``default``, or ``--experiment_id``) under ``$EM_EXPERIMENTS`` of the
assets, for the robustness tools. Prints one JSON line last.

    python -m empose_tpu_torch.tools.convergence_gate [--steps 600] [--resume_k 30] \\
        [--assets DIR] [--matmul_precision highest|high|default] [--experiment_id ID] \\
        [--device cpu]

``--assets`` defaults to ``gate_assets`` in the temporary directory and is
written there (``make_synthetic_assets``) where it is missing. Runs on CUDA
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.tools.gate_common import (asset_env, default_assets, fixed_batches,
                                                host_batch, lgd_retrain_config, mpjpe_fn,
                                                run_fixed, time_stats)
from empose_tpu_torch.train.loop import Trainer
from empose_tpu_torch.utils.experiments import get_model_dir

# ---- Recorded gate thresholds (flagship LGD, synthetic corpus, seed 17) ----
# MPJPE before any training sits near 200 mm on this corpus; 600 steps of the
# flagship config must at least bring it under 120 mm.
MPJPE_START_MIN = 150.0   # sanity: untrained error must be large
MPJPE_END_MAX = 120.0     # recorded ~95 mm + generous margin
RESUME_TOL = 1e-4         # post-resume losses == control, step for step
GATE_IDS = {"highest": "920000", "high": "920001", "default": "920002"}
REFERENCE_S_PER_STEP = 0.700  # the reference's example GPU step (reference README.md:230)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.convergence_gate")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--resume_k", type=int, default=30,
                   help="Steps per phase of the kill/resume check.")
    p.add_argument("--assets", default=None,
                   help="The asset tree (default: gate_assets in the temporary directory; "
                        "written where it is missing).")
    p.add_argument("--matmul_precision", default="highest",
                   choices=("highest", "high", "default"),
                   help="Run the whole gate (training + resume) at this NN/FK matmul "
                        "precision, the train CLI's knob.")
    p.add_argument("--experiment_id", default=None,
                   help="Keep the trained model under this experiment id instead of the "
                        "per-precision gate ids (920000/1/2).")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default) or cpu.")
    return p


def main(argv: Optional[list] = None) -> int:
    """Run the gate; print its JSON line; 0 where it passes, else 1."""
    args = parser().parse_args(argv)
    with asset_env(args.assets or default_assets("gate_assets"), args.device) as d:
        result = run_gate(args, d)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


def run_gate(args, d: str) -> dict:
    cfg = lgd_retrain_config(matmul_precision=args.matmul_precision)
    corpus = os.path.join(d, "data_synth", "amass_emr")
    failures = []

    # ---- 1. Convergence ---------------------------------------------------
    trainer = Trainer(cfg, seed=17, device=args.device)
    mpjpe = mpjpe_fn(trainer, 256)
    mpjpe_0 = mpjpe()
    print(f"MPJPE before training: {mpjpe_0:.2f} mm", flush=True)
    loader = EMRBatchLoader(corpus, cfg.bs_train, cfg.window_size,
                            shuffle=True, seed=7, pad_multiple=32, prefetch=2)
    step, t_steps, t0 = 0, [], time.time()
    first_loss = last_loss = None
    while step < args.steps:
        for b in loader:
            ts = time.time()
            loss = float(trainer.train_step(host_batch(b))["total_loss"])  # sync: honest wall
            if step > 1:
                t_steps.append(time.time() - ts)
            if first_loss is None:
                first_loss = loss
            last_loss = loss
            step += 1
            if step % 200 == 0:
                print(f"step {step}: loss {loss:.4f} ({time.time() - t0:.0f}s)", flush=True)
            if step >= args.steps:
                break
    mpjpe_n = mpjpe()
    # t_steps skips the first two steps (the kernels' first launches), so a
    # --steps <= 2 run has no samples; None keeps the JSON line valid.
    stats = time_stats(t_steps)
    s_per_step = stats["mean"]
    ms_txt = f"{s_per_step * 1e3:.1f}" if s_per_step is not None else "n/a"
    print(f"MPJPE after {step} steps: {mpjpe_n:.2f} mm ({ms_txt} ms/step end-to-end)",
          flush=True)
    print("step times (s, steps 3 on): " + json.dumps(stats), flush=True)

    # Keep the trained model as a standard experiment dir, so the eval CLI and
    # suppression_study load it by id against the gate assets.
    exp_root = os.environ["EM_EXPERIMENTS"]
    exp_id = args.experiment_id or GATE_IDS[args.matmul_precision]
    model_dir = get_model_dir(exp_root, exp_id)
    if model_dir is None:
        model_dir = os.path.join(exp_root, f"{exp_id}-gate-lgd-rnn6-{args.matmul_precision}")
        os.makedirs(model_dir, exist_ok=True)
    cfg.to_json(os.path.join(model_dir, "config.json"))
    trainer.save(model_dir)
    print(f"trained model saved as experiment {exp_id} ({model_dir})", flush=True)

    if not (mpjpe_0 > MPJPE_START_MIN):
        failures.append(f"untrained MPJPE {mpjpe_0:.1f} <= {MPJPE_START_MIN} (corpus drifted?)")
    if not (mpjpe_n < MPJPE_END_MAX):
        failures.append(f"trained MPJPE {mpjpe_n:.1f} >= {MPJPE_END_MAX}")
    if not (last_loss < first_loss):
        failures.append(f"loss did not drop: {first_loss:.4f} -> {last_loss:.4f}")

    # ---- 2. Kill / resume mid-run ------------------------------------------
    k = args.resume_k
    batches = fixed_batches(EMRBatchLoader(corpus, cfg.bs_train, cfg.window_size,
                                           shuffle=True, seed=9, pad_multiple=32), 2 * k)
    ckpt = os.path.join(d, "gate_ckpt")
    t_a = Trainer(cfg, seed=17, device=args.device)
    run_fixed(t_a, batches, k)
    t_a.save(ckpt)
    # Another seed: all state must come from the checkpoint.
    t_b = Trainer(cfg, seed=999, device=args.device)
    t_b.restore(ckpt)
    post = run_fixed(t_b, batches, k)
    control = run_fixed(Trainer(cfg, seed=17, device=args.device), batches, 2 * k)
    resume_diff = float(np.abs(np.asarray(post) - np.asarray(control[k:])).max())
    print(f"post-resume max |loss diff| vs uninterrupted: {resume_diff:.2e}", flush=True)
    if not (resume_diff < RESUME_TOL):
        failures.append(f"resume diverged: {resume_diff:.2e} >= {RESUME_TOL}")

    return {
        "gate": "convergence+resume",
        "matmul_precision": args.matmul_precision,
        "steps": args.steps,
        "mpjpe_before_mm": round(mpjpe_0, 2),
        "mpjpe_after_mm": round(mpjpe_n, 2),
        "s_per_step": round(s_per_step, 4) if s_per_step is not None else None,
        "reference_example_s_per_step": REFERENCE_S_PER_STEP,
        "resume_max_loss_diff": resume_diff,
        "ok": not failures,
        "failures": failures,
    }


if __name__ == "__main__":
    sys.exit(main())
