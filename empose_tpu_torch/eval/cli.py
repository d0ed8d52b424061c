"""Evaluate a trained model on the real EM-POSE recordings with the port.

    python -m empose_tpu_torch.eval --model_id <id> [--cross_subject] [--window_size W]
        [--serial | --host_metrics] [--visualize I] [--precision highest|high|default]
        [--suppression_length L [--suppression_markers K]] [--device cpu]

Port of ``scripts/evaluate_real.py``: the per-sequence metric rows and the
'Overall average' row (MPJPE, PA-MPJPE, MPJAE and their stds) of the
recordings in $EM_DATA_REAL, or of its ``hold_out`` subject with
``--cross_subject``, for the experiment ``--model_id`` in $EM_EXPERIMENTS.
The window defaults to 256 frames for an LGD/IEF model and to whole
sequences otherwise. ``--device`` defaults to CUDA and raises without it.
``--precision`` runs every pass (batched, serial, host oracle) with the NN
and kinematics GEMMs at that mode, as ``scripts/evaluate_real.py`` does
(``device.set_precision``); the metrics stay fp32. The knobs are restored
when the run ends. ``--suppression_length L`` (> 0) sets K random sensors
(``--suppression_markers``) of each window to 0 over a fraction L of its
valid frames (``data/noise.marker_suppression_noise_fn`` with the model's
sensor count), the same draws on every run; it runs the serial loop, or the
host oracle with ``--host_metrics``.
"""

from __future__ import annotations

import argparse
import os

from empose_tpu_torch import constants as C
from empose_tpu_torch.data.noise import marker_suppression_noise_fn
from empose_tpu_torch.device import precision_scope
from empose_tpu_torch.eval.harness import (evaluate_real_sequences, load_model_and_eval_data,
                                           print_metric_table)
from empose_tpu_torch.nn.models import IterativeErrorFeedback
from empose_tpu_torch.utils.experiments import get_model_dir


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.eval")
    p.add_argument("--model_id", required=True, help="Which end-to-end model to evaluate.")
    p.add_argument("--cross_subject", action="store_true",
                   help="Evaluate on the hold-out subject 0715.")
    p.add_argument("--window_size", type=int, default=None, help="Override the eval window size.")
    p.add_argument("--suppression_length", type=float, default=0.0,
                   help="Eval-time sensor dropout: the fraction of each window over which "
                        "random markers are suppressed (robustness study; runs serially).")
    p.add_argument("--suppression_markers", type=int, default=1,
                   help="How many markers are suppressed at a time.")
    p.add_argument("--precision", choices=("highest", "high", "default"), default="highest",
                   help="Matmul precision of the NN and kinematics GEMMs: 'highest' = fp32 "
                        "(TF32 off); 'high' = 3-pass bf16; 'default' = bf16 inputs.")
    p.add_argument("--host_metrics", action="store_true",
                   help="Aggregate on the host with MetricsEngine (the oracle) instead of the "
                        "batched pass.")
    p.add_argument("--serial", action="store_true",
                   help="One sequence at a time with statistics on the device, instead of the "
                        "batched pass of all sequences at once.")
    p.add_argument("--visualize", type=int, default=-1,
                   help="Dump skeleton and mesh artifacts (npz + OBJ) of the sequence with this "
                        "index into <model_dir>/visualize/.")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default) or cpu.")
    return p


def run(args: argparse.Namespace):
    """Evaluate and print the table; returns (rows, overall metrics)."""
    with precision_scope(args.precision):
        return _run(args)


def _run(args: argparse.Namespace):
    session, loader, config = load_model_and_eval_data(
        args.model_id, "test_real_0715" if args.cross_subject else "test_real",
        device=args.device)
    if args.suppression_length > 0.0:
        session.noise_fn = marker_suppression_noise_fn(
            args.suppression_length, args.suppression_markers, 0.0, config.n_markers)
    if args.window_size:
        window_size = args.window_size
    else:
        window_size = 256 if isinstance(session.model, IterativeErrorFeedback) else None
    model_dir = get_model_dir(C.experiment_dir(), args.model_id)
    rows, overall = evaluate_real_sequences(
        session, loader, window_size, visualize_index=args.visualize,
        visualize_dir=os.path.join(model_dir, "visualize"), host_metrics=args.host_metrics,
        serial=args.serial)
    print_metric_table(rows, args.model_id)
    return rows, overall


def main(argv=None):
    return run(parser().parse_args(argv))
