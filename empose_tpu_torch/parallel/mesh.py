"""Data parallelism over processes and devices (port of ``empose_tpu/parallel/mesh.py``).

The JAX package shards the batch axis of one jitted program over a 1-D
device mesh and lets XLA insert the gradient all-reduce. The port has two
forms of the same pure data parallelism:

* **Training over processes.** One process per rank (``spawn``), joined by
  ``torch.distributed`` (NCCL on CUDA, gloo on the CPU). Every rank reads the
  same global batch, pads it with :func:`pad_batch_to_devices` and keeps its
  rows (:func:`shard_batch`). Inside :func:`shard_scope` every random draw of
  a step is made at the global, unpadded batch shape from the rank's
  generator (identical on every rank) and the rank keeps its rows
  (:func:`batch_draw`), so a data-parallel step draws what the
  single-process step on the global batch draws; train-mode BatchNorm sums
  its statistics over the global batch (:func:`all_reduce_sum`, which is
  differentiable). The trainer averages the gradients (:func:`average_gradients`),
  so Adam moves the same parameters on every rank.
* **Serving and datagen over devices.** One process holds a replica per
  device of :func:`make_mesh`'s list and splits the stream (or batch) axis
  over them; there is nothing to reduce.

The JAX package gates its LSTM kernels on the per-device batch
(``_kernel_gate_ctx``, ``_kernel_ok_sharded``). The port has no such gate:
its kernels run, and beat their plain versions, at every batch size
(``PERF.md``, the N=1 rows), so every shard runs them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda") -> List[torch.device]:
    """The first ``n_devices`` devices of ``device_type`` (all CUDA cards for
    None). Raises ``ValueError`` where there are fewer CUDA cards than
    asked; it never falls back to fewer devices or to the CPU. ``"cpu"``
    gives the CPU ``n_devices`` times (the tests' devices)."""
    device_type = torch.device(device_type).type
    if device_type == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [torch.device("cuda", i) for i in range(have)]
    if n_devices is not None:
        if have < n_devices:
            raise ValueError(f"need {n_devices} devices, have {have}: {devices}")
        devices = devices[:n_devices]
    return devices


def pad_batch_to_devices(batch: Dict, n_devices: int) -> Dict:
    """Pad the batch axis to a multiple of ``n_devices`` by repeating the
    leading samples (wrap-around), with ``seq_lengths`` zeroed on the pads
    and ``ids`` extended. The pads add exactly 0 to every masked loss, and
    the trainer rescales the batch mean to the real samples."""
    n = batch["poses"].shape[0]
    target = ((n + n_devices - 1) // n_devices) * n_devices
    if target == n:
        return batch
    reps = np.arange(target - n) % n
    out = {}
    for k, v in batch.items():
        if k == "ids":
            out[k] = list(v) + [v[int(i)] for i in reps]
            continue
        v = np.asarray(v)
        if k == "seq_lengths":
            out[k] = np.concatenate([v, np.zeros(target - n, dtype=v.dtype)], axis=0)
        else:
            out[k] = np.concatenate([v, v[reps]], axis=0)
    return out


def shard_batch(batch: Dict, rank: int, n: int) -> Dict:
    """Rank ``rank``'s rows of a batch padded to a multiple of ``n``; ``ids``
    dropped, as the JAX ``shard_batch`` drops them."""
    per = batch["poses"].shape[0] // n
    return {k: np.asarray(v)[rank * per:(rank + 1) * per] for k, v in batch.items()
            if k != "ids"}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join this process to the group (``torch.distributed.init_process_group``).

    :param coordinator_address: ``host:port``, ``tcp://host:port`` or
      ``file:///path``; None reads ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).
    :param backend: default NCCL on CUDA and gloo on the CPU; ``"gloo"`` on
      CUDA tensors runs several ranks on one card.
    :param device: this rank's device (None: the current CUDA card where
      CUDA is present, else the CPU).
    """
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = "env://"
    if coordinator_address is not None:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)


def distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def _entry(rank: int, fn: Callable, devices: Sequence[str], backend: Optional[str],
           init_method: str, num_threads: int, args: tuple) -> None:
    torch.set_num_threads(num_threads)
    init_distributed(init_method, len(devices), rank, backend, devices[rank])
    try:
        fn(rank, torch.device(devices[rank]), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence, *args, backend: Optional[str] = None) -> None:
    """Run ``fn(rank, device, *args)`` as rank r on ``devices[r]`` in one
    spawned process per device, joined through a file in a temporary
    directory; returns when all are done and raises if any rank fails
    (the others are stopped). ``fn`` must be importable by name. Each rank
    gets this process's thread count. Tensors among ``args`` reach the ranks
    in shared memory (``torch.multiprocessing``): a rank that changes one
    copies it first."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_entry, args=(fn, [str(d) for d in devices], backend, init,
                                         torch.get_num_threads(), args),
                           nprocs=len(devices), join=True, start_method="spawn")


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``world`` holding its rows of a global batch of
    ``n_rows`` samples padded to ``n_padded``."""

    rank: int
    world: int
    n_rows: int
    n_padded: int

    @property
    def n_local(self) -> int:
        return self.n_padded // self.world

    def samples(self, device) -> torch.Tensor:
        """The global sample of each local row (pads wrap around, as
        :func:`pad_batch_to_devices` repeats them)."""
        g = torch.arange(self.rank * self.n_local, (self.rank + 1) * self.n_local, device=device)
        return torch.where(g < self.n_rows, g, (g - self.n_rows) % self.n_rows)


_SHARD: Optional[Shard] = None


@contextlib.contextmanager
def shard_scope(shard: Optional[Shard]):
    """Draws and BatchNorm statistics inside the block are those of the
    global batch (None: this process's batch, as without a group)."""
    global _SHARD
    previous, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = previous


def current_shard() -> Optional[Shard]:
    return _SHARD


def batch_draw(draw: Callable[[int], torch.Tensor], rows: int) -> torch.Tensor:
    """``draw(rows)``: a random tensor whose leading axis has ``rows`` rows,
    each sample's rows contiguous (``rows`` = samples x rows per sample).
    Inside :func:`shard_scope` it draws at the global batch and returns this
    rank's rows, so the generator moves as it does without a group."""
    shard = _SHARD
    if shard is None:
        return draw(rows)
    per = rows // shard.n_local
    if per * shard.n_local != rows:
        raise ValueError(f"{rows} rows are not a whole number of rows for each of the "
                         f"{shard.n_local} samples of this rank")
    full = draw(shard.n_rows * per)
    rest = full.shape[1:]
    picked = full.reshape(shard.n_rows, per, *rest)[shard.samples(full.device)]
    return picked.reshape(rows, *rest)


class _AllReduceSum(torch.autograd.Function):
    """``torch.distributed.nn.functional.all_reduce`` with SUM: the forward
    sums over the ranks, and so does the backward, since every rank's sum
    reads every rank's input."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (the backward sums the
    ranks' gradients); ``t`` itself outside :func:`shard_scope`."""
    if _SHARD is None:
        return t
    return _AllReduceSum.apply(t)


def from_first_rank(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (no gradient); ``t`` outside :func:`shard_scope`."""
    if _SHARD is None:
        return t
    t = t.detach().clone()
    dist.broadcast(t, src=0)
    return t


def average_gradients(params: Iterable[torch.nn.Parameter], world: int) -> None:
    """Replace every gradient by its mean over the ranks, in one all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_over_ranks(values: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the ranks, in one all-reduce."""
    names = list(values)
    flat = torch.stack([values[k].detach().reshape(()) for k in names])
    dist.all_reduce(flat)
    flat.div_(world)
    return dict(zip(names, flat.unbind()))
