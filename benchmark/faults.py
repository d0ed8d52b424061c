"""Faults planted underneath the timed path, to show that the comparison
catches them: on the CPU in ``benchmark/tests/test_bench_faults.py``, on
the card at a cell's own size through ``python3 -m benchmark.calibrate
--fault <name>``. Each patches the program for the process it runs in."""

from __future__ import annotations


def state_unchanged(setattr_):
    """A training step that computes its gradients and returns, its state unchanged."""
    from empose_tpu_torch.train import loop

    def step(self, host_batch):
        self.model.train()
        return loop.backward_step(self.model, self.pre_train, self.opt, self.upload(host_batch),
                                  self.generator)
    setattr_(loop.Trainer, "train_step", step)


def half_batch(setattr_):
    """Half of the batch left out, the mean taken over the rest."""
    from empose_tpu_torch.train import loop
    original = loop.Trainer.train_step

    def step(self, host_batch):
        n = host_batch["poses"].shape[0]
        return original(self, {k: v[: max(1, n // 2)] for k, v in host_batch.items()})
    setattr_(loop.Trainer, "train_step", step)


def answer_altered(setattr_, by: float = 1e-4):
    """Every served answer altered by ``by`` where the forward produces it."""
    from empose_tpu_torch import serve
    original = serve._forward

    def forward(*args, **kw):
        packed, widths, carry = original(*args, **kw)
        return packed + by, widths, carry
    setattr_(serve, "_forward", forward)


def streams_dropped(setattr_):
    """Half of the ready streams left out of each step's answers."""
    from empose_tpu_torch import serve
    original = serve.MultiStreamPredictor.step

    def step(self, flush_ids=()):
        outs = original(self, flush_ids)
        return {i: o for i, o in outs.items() if i % 2 == 0}
    setattr_(serve.MultiStreamPredictor, "step", step)


TRAIN = (state_unchanged, half_batch)
SERVE = (answer_altered, streams_dropped)
