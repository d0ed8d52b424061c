"""Training loop: ``Trainer`` (one step, the validation and test passes,
save, restore) and ``fit`` (port of ``empose_tpu/train/loop.py``).

One step: root normalization -> FK + sensor synthesis with mounting offsets
-> the model's train forward -> ``compute_loss`` -> rescaled to the real
samples of the batch -> ``+ reference_grad_extra_loss`` (LGD models) ->
backward -> Adam. Every LSTM direction-layer (the LGD init RNN, a (Bi)RNN's
LSTM) runs through the CUDA training pair on the card. ``--matmul_precision
high|default`` (``--bf16`` means ``default``; with another explicit mode it
raises, as in JAX) binds both precision knobs for the run, the NN GEMMs'
and the kinematics' (``device.set_precision``, as the JAX trainer binds
``set_nn_precision`` and ``set_fk_precision``): the training pair, the
input projections, the deferred ``dW_hh`` and the final validation and test
passes then run at that mode. Every random draw
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

import torch

from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.data import transforms as T
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.data.datasets import get_all_offset_files
from empose_tpu_torch.device import resolve_device, set_precision
from empose_tpu_torch.eval.harness import EvalSession, merge_stats, serial_pass
from empose_tpu_torch.eval.metrics import (MetricsEngine, metric_stats_init, metric_stats_update,
                                           stats_to_host)
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import IterativeErrorFeedback, SensorSMPL, create_model
from empose_tpu_torch.utils.logging import ScalarWriter, StepTimer

EVAL_SEED = 8004  # the validation pass's draws: batch b from EVAL_SEED + b, every pass alike


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
        self.pre_eval = T.make_preprocess_fn(self.model.smpl, self.bank, config, False)
        self._session = None
        self.match_reference_grads = match_reference_grads
        self.opt = torch.optim.Adam(self.model.parameters(), lr=config.lr, eps=1e-8)
        self.global_step = 0
        self.epoch = 0
        self.best_test_loss = float("inf")

    def upload(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch (numpy) -> tensors on the device; lengths as int64."""
        return to_device(host_batch, self.device)

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

    def session(self) -> EvalSession:
        """The eval session of the trained model, built at first use."""
        if self._session is None:
            self._session = EvalSession(self.model, self.smplh)
        return self._session

    @staticmethod
    def _mean_losses(pending) -> Dict[str, float]:
        """Sample-weighted means of ``[(loss dict of device scalars, weight)]``,
        read back in one copy."""
        if not pending:
            return {}
        names = list(pending[0][0])
        host = torch.stack([torch.stack([v[k] for k in names]) for v, _ in pending]).cpu()
        weights = torch.tensor([w for _, w in pending], dtype=torch.float64)
        means = (host.double() * weights[:, None]).sum(0) / weights.sum()
        return dict(zip(names, means.tolist()))

    def evaluate_valid(self, loader, metrics_engine: Optional[MetricsEngine] = None
                       ) -> Dict[str, float]:
        """The synthetic validation pass: each batch synthesized without
        randomization from a fixed generator (seeded ``EVAL_SEED`` + batch
        index, so every pass draws alike), the eval forward and its losses.
        With ``metrics_engine`` the metrics accumulate as statistics on the
        device and go to ``metrics_engine.set_stats`` at the end. The model
        runs in eval mode and returns to its mode after.

        :return: the loss values averaged over samples.
        """
        session = self.session()
        was_training = self.model.training
        self.model.eval()
        stats = metric_stats_init(device=self.device) if metrics_engine is not None else None
        pending = []
        with torch.no_grad():
            for b_idx, host_batch in enumerate(loader):
                g = torch.Generator(device=self.device).manual_seed(EVAL_SEED + b_idx)
                batch = self.pre_eval(self.upload(host_batch), g, mode="all")
                out, _ = self.model(batch, None)
                _, vals = self.model.compute_loss(batch, out)
                pending.append((vals, host_batch["poses"].shape[0]))
                if stats is not None:
                    stats = metric_stats_update(
                        session.body, stats, pose=batch["poses"][:, :, 3:], shape=batch["shapes"],
                        pose_hat=out["pose_hat"], shape_hat=out.get("shape_hat"),
                        seq_lengths=batch["seq_lengths"], pose_root=batch["poses"][:, :, :3],
                        pose_root_hat=out["root_ori_hat"])
        self.model.train(was_training)
        if metrics_engine is not None:
            metrics_engine.reset()
            metrics_engine.set_stats(stats_to_host(stats))
        return self._mean_losses(pending)

    def evaluate_test(self, loader, metrics_engine: Optional[MetricsEngine] = None,
                      window_size: Optional[int] = None) -> Dict[str, float]:
        """The real-data test pass: the eval harness's serial loop
        (:func:`serial_pass`: each sequence root-normalized, streamed window
        by window with the carry threaded, whole and padded to a multiple of
        256 without ``window_size``, the shape estimate frozen at its first
        window) with the loss values. With ``metrics_engine`` the merged
        statistics go to its ``set_stats``. The model returns to its mode
        after.

        :return: the loss values averaged over each sequence's windows, then
          over sequences.
        """
        was_training = self.model.training
        seqs = serial_pass(self.session(), loader, window_size, with_losses=True)
        self.model.train(was_training)
        if metrics_engine is not None:
            metrics_engine.reset()
            metrics_engine.set_stats(merge_stats([st for _, st, _, _ in seqs]))
        return self._mean_losses([(losses, n) for _, _, losses, n in seqs])

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


def fit(trainer: Trainer, train_loader, valid_loader, test_loader, model_dir: str,
        writer: Optional[ScalarWriter] = None, max_steps: Optional[int] = None) -> Dict[str, float]:
    """The training schedule of the JAX ``fit``: print every ``print_every``
    batches; every ``eval_every - 1`` steps the validation and the test pass
    with their metrics, and a checkpoint where the test loss is the best so
    far; stop after ``max_steps``; always leave a checkpoint.

    Loss values stay on the device until a print, an eval, ``max_steps`` or
    the end. A run that has steps already (``--resume``) fast-forwards the
    loader's random streams past them, so it sees the batches an
    uninterrupted run would.
    """
    config = trainer.config
    n_batches = len(train_loader)
    me = MetricsEngine(trainer.smplh, trainer.device)
    checkpoint_dir = os.path.join(model_dir, "checkpoint")
    start_epoch, start_i = divmod(trainer.global_step, n_batches)
    if trainer.global_step:
        train_loader.fast_forward(trainer.global_step)
    timer = StepTimer()
    print_mod = max(config.print_every - 1, 1)
    eval_mod = max(config.eval_every - 1, 1)
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

    def evaluate(i: int, epoch: int) -> None:
        valid_losses = trainer.evaluate_valid(valid_loader, me)
        valid_metrics = me.get_metrics()
        test_losses = trainer.evaluate_test(test_loader, me, config.eval_window_size)
        test_metrics = me.get_metrics()
        print(f"[VALID {i + 1:05d} | {epoch + 1:03d}] "
              + " ".join(f"{k}: {v:.6f}" for k, v in valid_losses.items()))
        print(f"[TEST  {i + 1:05d} | {epoch + 1:03d}] "
              + " ".join(f"{k}: {v:.6f}" for k, v in test_losses.items()), end="")
        current = test_losses.get("total_loss", float("inf"))
        if current < trainer.best_test_loss:
            print(" ***")
            trainer.best_test_loss = current
            trainer.save(model_dir)
        else:
            print()
        print(MetricsEngine.to_pretty_string(valid_metrics, "VALID"))
        print(MetricsEngine.to_pretty_string(test_metrics, "TEST"), flush=True)
        if writer:
            gs = trainer.global_step
            writer.add_scalars(valid_losses, gs, prefix="valid/")
            writer.add_scalars(test_losses, gs, prefix="test/")
            writer.add_scalars(MetricsEngine.to_log_dict(valid_metrics, "valid"), gs)
            writer.add_scalars(MetricsEngine.to_log_dict(test_metrics, "test"), gs)

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
            if trainer.global_step % eval_mod == 0:
                flush()
                evaluate(i, epoch)
                # Eval time is not billed to the next print window's steps.
                timer.reset()
                steps_in_window = 0
            if max_steps is not None and trainer.global_step >= max_steps:
                flush()
                if not os.path.isdir(checkpoint_dir):
                    trainer.save(model_dir)
                return last_vals
    flush()
    if not os.path.isdir(checkpoint_dir):
        trainer.save(model_dir)
    return last_vals
