"""Sensor-dropout robustness study: sweep eval-time marker suppression
(port of ``tools/suppression_study.py``).

Evaluates one trained model on the real recordings under a grid of
``suppression_length`` (the fraction of each window over which sensors are
dropped) x ``suppression_markers`` (how many at a time): the clean baseline
once, then every marker count at every positive length, each grid point in
a fresh eval session (so each sees the same draws window by window). Prints
the robustness table, and checks that the error grows with the length and
with the marker count (within 2 mm).

    python -m empose_tpu_torch.tools.suppression_study --model_id <id> \\
        [--lengths 0,0.25,0.5,1.0] [--markers 1,2] [--window_size N] \\
        [--cross_subject] [--out FILE] [--device cpu]

Exits 1 where the check finds a violation. ``--device`` defaults to CUDA
and raises without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.data.batches import collate_real
from empose_tpu_torch.data.datasets import Loader, RealDataset
from empose_tpu_torch.data.noise import marker_suppression_noise_fn
from empose_tpu_torch.eval.harness import EvalSession, evaluate_real_sequences
from empose_tpu_torch.eval.metrics import format_table
from empose_tpu_torch.nn.models import IterativeErrorFeedback
from empose_tpu_torch.utils.experiments import load_model

GRID_KEYS = ("suppression_markers", "suppression_length")


def run_study(model_id, lengths, markers_list, window_size: Optional[int] = None,
              cross_subject: bool = False, device=None) -> List[dict]:
    """One row per grid point: its marker count, its length and the overall
    metrics rounded to 3 decimals. The window defaults to 256 frames for an
    LGD/IEF model and to whole sequences otherwise."""
    model, config, _ = load_model(model_id, device=device)
    smplh = load_smplh()
    data_dir = C.data_dir_real()
    if cross_subject:
        data_dir = os.path.join(data_dir, "hold_out")
    ds = RealDataset(data_dir)
    ws = window_size or (256 if isinstance(model, IterativeErrorFeedback) else None)

    rows = []
    # Length 0 is the same for any marker count: the clean baseline once.
    grid = [(0, 0.0)] + [(m, length) for m in markers_list for length in lengths if length > 0.0]
    for n_markers, length in grid:
        noise_fn = None
        if length > 0.0:
            noise_fn = marker_suppression_noise_fn(length, n_markers, 0.0, config.n_markers)
        session = EvalSession(model, smplh, noise_fn=noise_fn)
        loader = Loader(ds, batch_size=1, collate_fn=collate_real, shuffle=False)
        _, overall = evaluate_real_sequences(session, loader, ws)
        rows.append({"suppression_markers": n_markers, "suppression_length": length,
                     **{k: round(float(v), 3) for k, v in overall.items()}})
        print(f"  markers={n_markers} length={length}: "
              + " ".join(f"{k}={v}" for k, v in rows[-1].items() if k not in GRID_KEYS),
              flush=True)
    return rows


def check_monotone(rows, tol_mm: float = 2.0) -> List[str]:
    """MPJPE must not fall by more than ``tol_mm`` as the length grows (per
    marker count, from the clean baseline) or as the marker count grows
    (per length): dropping more sensor signal for longer must not make a
    model better.

    :return: the violations as text (empty: the check passes).
    """
    base = next(r for r in rows if r["suppression_length"] == 0.0)
    violations = []
    by_markers = {}
    for r in rows:
        if r["suppression_length"] > 0.0:
            by_markers.setdefault(r["suppression_markers"], []).append(r)
    for m, rs in by_markers.items():
        chain = [base] + sorted(rs, key=lambda r: r["suppression_length"])
        for a, b in zip(chain, chain[1:]):
            if b["MPJPE [mm]"] < a["MPJPE [mm]"] - tol_mm:
                violations.append(
                    f"markers={m}: MPJPE {b['MPJPE [mm]']:.2f} at length "
                    f"{b['suppression_length']} < {a['MPJPE [mm]']:.2f} at "
                    f"length {a['suppression_length']} (tol {tol_mm} mm)")
    lengths = sorted({r["suppression_length"] for r in rows if r["suppression_length"] > 0.0})
    for length in lengths:
        chain = sorted((r for r in rows if r["suppression_length"] == length),
                       key=lambda r: r["suppression_markers"])
        for a, b in zip(chain, chain[1:]):
            if b["MPJPE [mm]"] < a["MPJPE [mm]"] - tol_mm:
                violations.append(
                    f"length={length}: MPJPE {b['MPJPE [mm]']:.2f} with "
                    f"{b['suppression_markers']} markers dropped < "
                    f"{a['MPJPE [mm]']:.2f} with {a['suppression_markers']} (tol {tol_mm} mm)")
    return violations


def to_table(rows) -> str:
    """The robustness table, one line per grid point."""
    keys = [k for k in rows[0] if k not in GRID_KEYS]
    headers = ["dropped markers", "dropout length (frac of window)"] + keys
    return format_table(headers, [[r["suppression_markers"], r["suppression_length"]]
                                  + [r[k] for k in keys] for r in rows])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.suppression_study")
    p.add_argument("--model_id", required=True)
    p.add_argument("--lengths", default="0,0.25,0.5,1.0",
                   help="Comma-separated suppression_length values (0 = clean baseline).")
    p.add_argument("--markers", default="1,2", help="Comma-separated suppression_markers values.")
    p.add_argument("--window_size", type=int, default=None)
    p.add_argument("--cross_subject", action="store_true")
    p.add_argument("--out", default=None, help="Also write the rows as JSON here.")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default) or cpu.")
    return p


def main(argv=None) -> int:
    """Run the study and print its table; 1 where the check fails, else 0."""
    args = parser().parse_args(argv)
    lengths = sorted(float(x) for x in args.lengths.split(","))
    markers = [int(x) for x in args.markers.split(",")]
    rows = run_study(args.model_id, lengths, markers, args.window_size, args.cross_subject,
                     args.device)
    print()
    print(to_table(rows))
    violations = check_monotone(rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "monotone_ok": not violations, "violations": violations},
                      f, indent=2)
    if violations:
        print("\nMONOTONICITY VIOLATIONS (robustness regression):")
        for v in violations:
            print("  " + v)
        return 1
    print("\nmonotonicity check: OK (degradation monotone in length and marker count)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
