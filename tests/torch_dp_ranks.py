"""The ranks of the port's data-parallel tests (``tests/test_torch_parallel.py``).

``parallel.mesh.spawn`` imports these functions by name in each rank's
process; the module imports torch and the port only, so a rank starts
without jax.
"""

import copy

import torch

from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.parallel import mesh as M
from empose_tpu_torch.tools.multihost_worker import run_steps
from empose_tpu_torch.train.loop import Trainer, data_parallel_batch, train_loss


def trainer_steps(rank, device, config, seed, batches, out):
    """A trainer's steps one by one (``first``: its state after the first),
    and a second trainer's as one chunk, written to ``out % rank``."""
    torch.save(steps_and_chunk(Trainer(config, seed=seed, device=device),
                               Trainer(config, seed=seed, device=device), batches), out % rank)


def steps_and_chunk(trainer, chunk_trainer, batches):
    """``trainer``'s first step, then the others one by one; ``chunk_trainer``'s
    steps as one chunk."""
    first = run_steps(trainer, batches[:1])
    singles = run_steps(trainer, batches[1:])
    singles["vals"] = first["vals"] + singles["vals"]
    return {"first": first, "singles": singles,
            "chunk": run_steps(chunk_trainer, batches, chunk=True)}


def loss_and_grads(rank, device, model, window, out):
    """The data-parallel train loss of ``model`` on a synthesized ``window``
    (the global batch) and its gradients averaged over the ranks, without
    dropout, written to ``out % rank``."""
    world = torch.distributed.get_world_size()
    # The spawned ranks share the storage of tensors passed to them: a copy
    # of its own keeps each rank's BatchNorm updates and gradients apart.
    model = copy.deepcopy(model).to(device).train()
    host, shard, pad_scale = data_parallel_batch(window, rank, world, device)
    with M.shard_scope(shard):
        loss, vals = train_loss(model, to_device(host, device), None, pad_scale)
        loss.backward()
    M.average_gradients(model.parameters(), world)
    vals = M.mean_over_ranks({k: v.detach() for k, v in vals.items()}, world)
    torch.save({"vals": {k: float(v) for k, v in vals.items()},
                "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
                "buffers": {k: b.cpu() for k, b in model.named_buffers()}}, out % rank)
