"""The ``--remat`` crossover: step time and transient device memory, with
and without it (port of ``tools/measure_remat.py``).

``--remat`` runs the LGD loop's FK + sensor blocks under
``torch.utils.checkpoint`` (``IterativeErrorFeedback._forward_train``): the
loop otherwise holds N+1 sets of FK activations for the backward. For each
(batch, window) regime this records the training step's time
(``profile_common.run_train_step``: best of timed blocks, and their
median) and the memory of one step, the two sides of the trade.

    python -m empose_tpu_torch.tools.measure_remat [--regimes 64x256,128x256,64x512]
        [--iters 10] [--precision highest] [--device cpu]

``memory`` keeps the keys of XLA's ``memory_analysis`` of the JAX tool's
compiled step (``bench.py``), read on the card as:
  * ``temp_mb``: ``torch.cuda.max_memory_allocated`` over one step minus
    what was allocated before it (XLA: the program's temporaries, the
    activations and workspace remat trades for operations);
  * ``argument_mb``: the parameters, the Adam state and the batch going
    into the step (XLA: the program's arguments);
  * ``output_mb``: the parameters and the Adam state after it (XLA: its
    outputs).
On the CPU ``memory`` is None, as the JAX tool's where a backend has no
analysis. Runs on CUDA unless ``--device cpu``; ``main`` returns the rows,
the JAX tool's keys and ``step_ms_median``, ``steps`` (every step taken)
and ``flops_per_frame`` (the count the timing guard's floor came from).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import resolve_device
from empose_tpu_torch.tools.profile_common import run_train_step


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.measure_remat")
    p.add_argument("--regimes", default="64x256",
                   help="Comma-separated BSxWINDOW list, e.g. 64x256,128x256.")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--precision", default="highest")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    return p


def main(argv: Optional[list] = None, config: Optional[Configuration] = None, warmup: int = 3,
         repeats: int = 4) -> List[dict]:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for spec in args.regimes.split(","):
        bs, w = (int(x) for x in spec.lower().split("x"))
        for remat in (False, True):
            ms, flops_per_frame, mem, extras = run_train_step(
                iters=args.iters, warmup=warmup, repeats=repeats, bs=bs, window=w,
                precision=args.precision, remat=remat, want_memory=True, device=dev,
                config=config)
            rows.append({"bs": bs, "window": w, "remat": remat, "precision": args.precision,
                         "step_ms": round(ms, 2), "memory": mem,
                         "step_ms_median": round(extras["ms_median"], 2),
                         "steps": extras["steps"], "flops_per_frame": flops_per_frame})
            print(f"bs{bs} x w{w} remat={remat}: {ms:.2f} ms (median {extras['ms_median']:.2f}), "
                  f"mem={mem}", flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
