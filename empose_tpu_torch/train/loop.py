"""Training loop: ``Trainer`` (one step, save, restore) and ``fit``
(port of ``empose_tpu/train/loop.py``).

One step: root normalization -> FK + sensor synthesis with mounting offsets
-> the model's train forward -> ``compute_loss`` -> rescaled to the real
samples of the batch -> ``+ reference_grad_extra_loss`` (LGD models) ->
backward -> Adam. Every LSTM direction-layer (the LGD init RNN, a (Bi)RNN's
LSTM) runs through the CUDA training pair on the card. Every random draw
(offsets, dropout) comes from one ``torch.Generator`` on the device, seeded
from the run's seed and saved with the train state, so a resumed run
continues bit for bit.

Torch's Adam is optax's: the same bias correction, eps outside the square
root. ``steps_per_call`` (the JAX package's K steps per XLA program) is
parsed and the port runs one step per call; CUDA-graph capture of K steps
is open work (ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.data import transforms as T
from empose_tpu_torch.data.datasets import get_all_offset_files
from empose_tpu_torch.device import resolve_device, set_precision
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import IterativeErrorFeedback, SensorSMPL, create_model
from empose_tpu_torch.utils.logging import ScalarWriter, StepTimer

EVAL_NOT_PORTED = ("validation and test passes are not ported yet: ROADMAP.md, queue 1, "
                   "'Real-data evaluation' (and the eval hooks of fit); set --eval_every "
                   "beyond the run")


def _precision(config) -> str:
    prec = getattr(config, "matmul_precision", "highest") or "highest"
    if getattr(config, "bf16", False):
        if prec not in ("highest", "default"):
            raise ValueError(f"--bf16 conflicts with --matmul_precision {prec}: "
                             "--bf16 means --matmul_precision default; pass one or the other")
        prec = "default"
    return prec


def _refuse_unported(config) -> None:
    if max(1, int(getattr(config, "dp_devices", 1))) > 1:
        raise NotImplementedError("--dp_devices > 1 is not ported yet: ROADMAP.md, queue 1, "
                                  "'Data parallelism'")
    for flag in ("remat", "profile_dir"):
        if getattr(config, flag, None):
            raise NotImplementedError(f"--{flag} is not ported yet: ROADMAP.md, queue 1, "
                                      "'Trainer options'")


class Trainer:
    """Model, optimizer, data synthesis and the random stream of one run.

    :param device: None = CUDA (raises without it); ``"cpu"`` for tests.
    """

    def __init__(self, config, seed: Optional[int] = None, match_reference_grads: bool = True,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        set_precision(_precision(config))
        _refuse_unported(config)
        # Seed 0 is a seed: the JAX trainer's ``config.seed or time.time()``
        # turns it into the clock.
        if seed is None:
            seed = config.seed if config.seed is not None else time.time()
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.smplh = load_smplh()
        offset_files = list(get_all_offset_files().values())
        self.bank = T.OffsetBank.from_offset_files(offset_files, device=self.device)
        model = create_model(config, SensorSMPL(self.smplh))
        init_parameters(model, torch.Generator().manual_seed(self.seed))
        self.model = model.to(self.device).train()
        self.pre_train = T.make_preprocess_fn(self.model.smpl, self.bank, config, True)
        self.match_reference_grads = match_reference_grads
        self.opt = torch.optim.Adam(self.model.parameters(), lr=config.lr, eps=1e-8)
        self.global_step = 0
        self.epoch = 0
        self.best_test_loss = float("inf")

    def upload(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch (numpy) -> tensors on the device; lengths as int64."""
        out = {}
        for k, v in host_batch.items():
            if k == "ids":
                continue
            t = torch.as_tensor(np.asarray(v))
            out[k] = t.to(self.device, torch.int64 if k == "seq_lengths" else torch.float32)
        return out

    def loss(self, batch: Dict[str, torch.Tensor]):
        """The train loss of a synthesized batch: ``(loss_for_grad, vals)``.
        Zero-length samples contribute 0 to every masked loss, and the batch
        mean is rescaled to the real samples."""
        lengths = batch["seq_lengths"]
        pad_scale = lengths.shape[0] / (lengths > 0).sum().clamp(min=1).to(torch.float32)
        out, _ = self.model(batch, None, self.generator)
        total, vals = self.model.compute_loss(batch, out)
        vals = {k: v * pad_scale for k, v in vals.items()}
        loss = total * pad_scale
        if isinstance(self.model, IterativeErrorFeedback) and self.match_reference_grads:
            loss = loss + self.model.reference_grad_extra_loss(out) * pad_scale
        return loss, vals

    def train_step(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the loss values as device scalars."""
        self.model.train()
        batch = self.pre_train(self.upload(host_batch), self.generator, mode="all")
        loss, vals = self.loss(batch)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.global_step += 1
        return {k: v.detach() for k, v in vals.items()}

    def train_state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.opt.state_dict(),
                "global_step": self.global_step, "epoch": self.epoch,
                "best_test_loss": self.best_test_loss,
                "generator": self.generator.get_state()}

    def save(self, model_dir: str) -> None:
        """The full train state to ``<model_dir>/checkpoint/train_state.pt`` and
        a reference-layout ``<model_dir>/model.pth`` ({"model_state_dict": ...})
        for ``load_model`` and serving."""
        os.makedirs(os.path.join(model_dir, "checkpoint"), exist_ok=True)
        torch.save(self.train_state_dict(), os.path.join(model_dir, "checkpoint", "train_state.pt"))
        torch.save({"model_state_dict": self.model.state_dict(), "iteration": self.global_step,
                    "epoch": self.epoch}, os.path.join(model_dir, "model.pth"))

    def restore(self, model_dir: str) -> None:
        state = torch.load(os.path.join(model_dir, "checkpoint", "train_state.pt"),
                           map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"], strict=True)
        self.opt.load_state_dict(state["optimizer"])
        self.global_step = int(state["global_step"])
        self.epoch = int(state["epoch"])
        self.best_test_loss = float(state["best_test_loss"])
        self.generator.set_state(state["generator"])


def _first_eval_step(global_step: int, eval_every: int) -> int:
    """The first global step after ``global_step`` at which the JAX loop
    would evaluate."""
    eval_mod = max(eval_every - 1, 1)
    return (global_step // eval_mod + 1) * eval_mod


def fit(trainer: Trainer, train_loader, model_dir: str, writer: Optional[ScalarWriter] = None,
        max_steps: Optional[int] = None) -> Dict[str, float]:
    """The training schedule of the JAX ``fit``: print every ``print_every``
    batches, stop after ``max_steps``, always leave a checkpoint.

    Loss values stay on the device until a print, ``max_steps`` or the end.
    A run that has steps already (``--resume``) fast-forwards the loader's
    random streams past them, so it sees the batches an uninterrupted run
    would. Validation and test passes are not ported: a run that would reach
    an eval boundary raises ``NotImplementedError`` before its first step.
    """
    config = trainer.config
    n_batches = len(train_loader)
    last_step = config.n_epochs * n_batches
    if max_steps is not None:
        last_step = min(last_step, max(max_steps, trainer.global_step + 1))
    if trainer.global_step < last_step and \
            _first_eval_step(trainer.global_step, config.eval_every) <= last_step:
        raise NotImplementedError(EVAL_NOT_PORTED)

    checkpoint_dir = os.path.join(model_dir, "checkpoint")
    start_epoch, start_i = divmod(trainer.global_step, n_batches)
    if trainer.global_step:
        train_loader.fast_forward(trainer.global_step)
    timer = StepTimer()
    print_mod = max(config.print_every - 1, 1)
    last_vals: Dict[str, float] = {}
    pending = []  # (global step, device loss dict) since the last flush
    steps_in_window = 0

    def flush():
        nonlocal last_vals
        if not pending:
            return
        names = list(pending[0][1])
        host = torch.stack([torch.stack([v[k] for k in names]) for _, v in pending]).tolist()
        for (gs, _), row in zip(pending, host):
            last_vals = dict(zip(names, row))
            if writer:
                writer.add_scalars(last_vals, gs, prefix="train/")
                writer.add_scalar("lr", config.lr, gs)
        pending.clear()

    for epoch in range(start_epoch, config.n_epochs):
        trainer.epoch = epoch
        for i, batch in enumerate(train_loader, start=start_i if epoch == start_epoch else 0):
            pending.append((trainer.global_step + 1, trainer.train_step(batch)))
            steps_in_window += 1
            if i % print_mod == 0:
                flush()
                per_step = timer.reset() / max(steps_in_window, 1)
                steps_in_window = 0
                loss_string = " ".join(f"{k}: {v:.6f}" for k, v in last_vals.items())
                print(f"[TRAIN {i + 1:05d} | {epoch + 1:03d}] {loss_string} "
                      f"elapsed: {per_step:.3f} secs", flush=True)
            if max_steps is not None and trainer.global_step >= max_steps:
                flush()
                if not os.path.isdir(checkpoint_dir):
                    trainer.save(model_dir)
                return last_vals
    flush()
    if not os.path.isdir(checkpoint_dir):
        trainer.save(model_dir)
    return last_vals
