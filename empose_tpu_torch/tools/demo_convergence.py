"""Convergence demo: train a BiRNN on the synthetic corpus and watch the
held-out MPJPE drop (port of ``tools/demo_convergence.py``).

End-to-end sanity of the learning dynamics (data synthesis -> model ->
losses -> optimizer): a 2x128 bidirectional LSTM with a 64-unit shape MLP
on 12 sensors, batch 16 x window 32, lr 1e-3, seed 5, evaluated on the
real recordings over whole sequences before and after ``--steps`` steps.
With the self-consistent synthetic assets the model genuinely fits.

    python -m empose_tpu_torch.tools.demo_convergence [--steps 600] [--assets DIR] \\
        [--device cpu]

``--assets`` defaults to ``conv_assets`` in the temporary directory and is
written there (``make_synthetic_assets``) where it is missing. ``main``
returns the MPJPE before and after in mm. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.tools.gate_common import asset_env, default_assets, host_batch, mpjpe_fn
from empose_tpu_torch.train.loop import Trainer


def birnn_config() -> Configuration:
    """The demo's BiRNN: 2x128 bidirectional, shape MLP 64, 12 markers."""
    return Configuration.from_dict(dict(
        m_type="rnn", m_bidirectional=True, m_hidden_size=128, m_num_layers=2,
        m_estimate_shape=True, m_shape_hidden_size=64, m_average_shape=True,
        use_marker_pos=True, use_marker_ori=True, use_real_offsets=True,
        offset_noise_level=0, n_markers=12, window_size=32, bs_train=16, lr=1e-3, seed=5))


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.demo_convergence")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--assets", default=None,
                   help="The asset tree (default: conv_assets in the temporary directory; "
                        "written where it is missing).")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default) or cpu.")
    args = p.parse_args(argv)
    with asset_env(args.assets or default_assets("conv_assets"), args.device) as d:
        cfg = birnn_config()
        trainer = Trainer(cfg, device=args.device)
        loader = EMRBatchLoader(os.path.join(d, "data_synth", "amass_emr"), 16, 32,
                                shuffle=True, seed=5, pad_multiple=32)
        mpjpe = mpjpe_fn(trainer, None)
        before = mpjpe()
        print("MPJPE before:", round(before, 2), flush=True)
        step, t0 = 0, time.time()
        while step < args.steps:
            for batch in loader:
                vals = trainer.train_step(host_batch(batch))
                step += 1
                if step % 500 == 0:
                    print(f"step {step}: loss {float(vals['total_loss']):.4f} "
                          f"({time.time() - t0:.0f}s)", flush=True)
                if step >= args.steps:
                    break
        last_loss = float(vals["total_loss"]) if step else None  # waits for the last step
        wall = time.time() - t0
        after = mpjpe()
        print(f"MPJPE after {step} steps:", round(after, 2), flush=True)
    return {"mpjpe_before_mm": before, "mpjpe_after_mm": after, "steps": step,
            "last_loss": last_loss, "train_s": wall}


if __name__ == "__main__":
    main()
