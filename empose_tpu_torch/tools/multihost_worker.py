"""Multi-process data-parallel worker: one full training step, 2+ processes
(port of ``tools/multihost_worker.py``).

Run once per process::

    python -m empose_tpu_torch.tools.multihost_worker <pid> <nproc> <port or init URL> \\
        [--device cpu]

Each process first takes the step alone on the full batch (the reference),
then joins the group through ``parallel.mesh.init_distributed`` (``<port>``
means ``tcp://localhost:<port>``; a ``file://`` or ``tcp://`` URL is used
as it is) and takes the same step as one rank of a data-parallel trainer
(``train/loop.Trainer``: on-device synthesis, LGD forward, gradients
averaged over the ranks, Adam). It checks that the step's loss equals the
reference's (relative 1e-4, as the JAX worker) and its parameters the
reference's (atol 2e-3: Adam's first update is about lr x sign(gradient),
so a near-zero gradient summed in another order can flip), that the
parameters moved and that they are bit for bit those of rank 0, and prints
``MULTIHOST DP OK``. The model is the tiny LGD-RNN of the JAX worker on the
asset tree of ``$SMPL_MODELS`` and ``$EM_DATA_REAL``. Runs on CUDA (rank r on
card r % count, NCCL) unless ``--device cpu`` (gloo).

:func:`run_steps` is the library part: a trainer's steps and what they
leave, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import resolve_device
from empose_tpu_torch.parallel import mesh as M
from empose_tpu_torch.tools.bench_serve import FLAGSHIP, TINY
from empose_tpu_torch.tools.profile_common import tiny_batch
from empose_tpu_torch.train.loop import Trainer


def tiny_config(**overrides) -> Configuration:
    """The JAX worker's tiny LGD-RNN (``_flagship_config(tiny=True)``)."""
    return Configuration.from_dict(dict(FLAGSHIP, **TINY, **overrides))


def run_steps(trainer: Trainer, batches: List[Dict], chunk: bool = False) -> Dict:
    """``trainer``'s steps on ``batches`` (one ``train_step_chunk`` with
    ``chunk``): the loss values of each step, the model's state (parameters
    and BatchNorm statistics) and the generator's, all on the CPU."""
    if chunk:
        vals = trainer.train_step_chunk(batches)
        vals = [{k: v[j] for k, v in vals.items()} for j in range(len(batches))]
    else:
        vals = [trainer.train_step(b) for b in batches]
    return {"vals": [{k: float(v) for k, v in s.items()} for s in vals],
            "state": {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
            "generator": trainer.generator.get_state()}


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"multihost_worker: {msg}")


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.multihost_worker")
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("address", help="a port on localhost, or a tcp:// or file:// URL")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
    address = args.address if "://" in args.address else f"tcp://localhost:{args.address}"

    config = tiny_config()
    batch = tiny_batch(np.random.RandomState(0), n=args.num_processes * 2 + 1, f=8)
    # The reference: the same step in this process alone, on the full batch.
    ref = Trainer(config, seed=1, device=device)
    before = {k: v.detach().clone() for k, v in ref.model.state_dict().items()}
    ref_run = run_steps(ref, [batch])

    M.init_distributed(address, args.num_processes, args.process_id, device=device)
    try:
        got = run_steps(Trainer(config, seed=1, device=device), [batch])
        flat = torch.cat([v.reshape(-1).float() for v in got["state"].values()]).to(device)
        first = flat.clone()
        dist.broadcast(first, src=0)
        same_as_rank0 = bool(torch.equal(flat, first))
    finally:
        dist.destroy_process_group()

    dp_loss, ref_loss = got["vals"][0]["total_loss"], ref_run["vals"][0]["total_loss"]
    _check(np.isfinite(dp_loss) and abs(dp_loss - ref_loss) < 1e-4 * max(1.0, abs(ref_loss)),
           f"the DP loss {dp_loss} is not the single-process loss {ref_loss}")
    delta = 0.0
    for k, v in got["state"].items():
        if v.is_floating_point():
            err = float((v - ref_run["state"][k]).abs().max())
            _check(err <= 2e-3, f"{k} lies {err} from the single-process step's")
            delta += float((v - before[k].cpu()).abs().sum())
    _check(delta > 0.0, "the parameters did not move")
    _check(same_as_rank0, "the parameters differ from rank 0's")
    print(f"MULTIHOST DP OK pid={args.process_id} loss={dp_loss:.6f} ref={ref_loss:.6f} "
          f"devices={args.num_processes}", flush=True)


if __name__ == "__main__":
    main()
