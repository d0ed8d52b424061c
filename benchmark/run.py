"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes its inputs and weights from ``--seed``, loads and warms up
the program (``empose_tpu_torch``) for the cell's shapes, measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints one JSON object. With ``--trace 0`` its metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
It needs as many CUDA cards as the cell asks for, and exits with another
code than 0, printing no result, without them, or if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout, and
    no library loading JAX behind the program's back. The program's own
    kernels build into ``empose_tpu_torch/_build/``, also inside it."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    pin_caches()
    sys.path.insert(0, ROOT)
    from benchmark import harness

    run = harness.Run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      started=STARTED)
    import torch
    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = harness.execute(run)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, item in result["compared"].items():
        print(f"compared {name}: {item['value']!r} limit {item['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
