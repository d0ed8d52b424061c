"""The readings that a cell's limits are set from: for each seed, the gaps
of a sound run of the program and the gaps of the control (the reference at
TF32 in the program's place), in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--seconds 5]
        [--control_seeds 3] [--fault half_batch]

Prints one JSON line per seed and a last line with the largest sound
reading and the smallest control reading of every compared number. A train
cell needs no window (its checked steps are in set-up); a serving cell runs
a short one at its own load to have chunks to check. With ``--fault`` the
program runs with that fault of ``benchmark/faults.py`` planted, and its
readings are the fault's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: str, seeds: List[int], seconds: float, device: str = "cuda",
             root: str = ROOT, control_seeds: int = 1 << 30) -> List[Dict]:
    """Sound readings on every seed, the control's on the first ``control_seeds``."""
    from benchmark import harness
    rows = []
    for n, seed in enumerate(seeds):
        run = harness.Run(root, cell, seed, seconds, False, device=device)
        mod = harness.driver(run)
        with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
            run.tmp = tmp
            state = mod.setup(run)
            mod.window(run, state)
            mod.check(run, state)
            sound = {name: value for name, value, _ in run.numbers}
            control = mod.control(run, state) if n < control_seeds else None
            more = mod.details(state) if hasattr(mod, "details") else {}
            sound = more.pop("readings", sound)   # every number, compared or not
        rows.append({"seed": seed, "failed": run.failed, "sound": sound, "control": control,
                     "limits": run.limits, **more})
        print(json.dumps(rows[-1]), flush=True)
        del state, run
        gc.collect()
        if device == "cuda":
            import torch
            torch.cuda.empty_cache()
    return rows


def summary(rows: List[Dict]) -> Dict:
    names = rows[0]["sound"]
    controls = [r["control"] for r in rows if r["control"] is not None]
    return {name: {"sound_max": max(r["sound"][name] for r in rows),
                   "control_min": min((c[name] for c in controls), default=None)}
            for name in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.fault:
        from benchmark import faults
        getattr(faults, args.fault)(setattr)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                    control_seeds=args.control_seeds)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
