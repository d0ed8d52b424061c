"""Training loop: ``Trainer`` (one step, the validation and test passes,
save, restore) and ``fit`` (port of ``empose_tpu/train/loop.py``).

One step: root normalization -> FK + sensor synthesis with mounting offsets
-> the configured sensor noise (``data/noise.py``) -> the model's train
forward -> ``compute_loss`` -> rescaled to the real samples of the batch ->
``+ reference_grad_extra_loss`` (LGD models) -> backward -> Adam. Every LSTM direction-layer (the LGD init RNN, a (Bi)RNN's
LSTM) runs through the CUDA training pair on the card. ``--matmul_precision
high|default`` (``--bf16`` means ``default``; with another explicit mode it
raises, as in JAX) binds both precision knobs for the run, the NN GEMMs'
and the kinematics' (``device.set_precision``, as the JAX trainer binds
``set_nn_precision`` and ``set_fk_precision``): the training pair, the
input projections, the deferred ``dW_hh`` and the final validation and test
passes then run at that mode. ``--remat`` recomputes the LGD model's FK
blocks in the backward (``IterativeErrorFeedback._forward_train``). Every
random draw (offsets, noise, dropout) comes from one ``torch.Generator`` on
the device, seeded from the run's seed and saved with the train state, so a
resumed run continues bit for bit.

Torch's Adam is optax's: the same bias correction, eps outside the square
root. ``steps_per_call`` K: ``fit`` hands up to K batches at a time to
:meth:`Trainer.train_step_chunk`, cut where K=1 would print, evaluate or
stop, and where the batch shape changes, as the JAX ``fit`` cuts them. A
chunk runs its K steps one after another, so its losses and weights equal
K single steps bit for bit; the JAX package's one program per chunk
(``lax.scan``) has no counterpart yet (capturing a chunk as one CUDA graph
is speed work, ROADMAP.md).

Data parallelism (``--dp_devices N``, ``parallel/mesh.py``): in a process
group every rank reads the same global batch, pads it to a multiple of the
world, keeps its rows and draws at the global batch; BatchNorm takes the
global batch's statistics, the gradients and the loss values are averaged
over the ranks (the batch mean rescaled by the global lengths), and Adam
moves the same parameters on every rank. Rank 0 alone prints, evaluates,
writes the checkpoint and the scalars; the others wait at a barrier.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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
from empose_tpu_torch.parallel import mesh as M
from empose_tpu_torch.utils.logging import ScalarWriter, StepTimer
from empose_tpu_torch.utils.profiling import span

EVAL_SEED = 8004  # the validation pass's draws: batch b from EVAL_SEED + b, every pass alike


def _precision(config) -> str:
    prec = getattr(config, "matmul_precision", "highest") or "highest"
    if getattr(config, "bf16", False):
        if prec not in ("highest", "default"):
            raise ValueError(f"--bf16 conflicts with --matmul_precision {prec}: "
                             "--bf16 means --matmul_precision default; pass one or the other")
        prec = "default"
    return prec


def train_loss(model, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
               pad_scale: Optional[torch.Tensor] = None, match_reference_grads: bool = True):
    """``model``'s train loss on a synthesized batch: ``(loss_for_grad, vals)``.
    Zero-length samples contribute 0 to every masked loss, and the batch
    mean is rescaled to the real samples (``pad_scale``: rows over real
    samples, by default this batch's); LGD models add
    ``reference_grad_extra_loss``."""
    if pad_scale is None:
        lengths = batch["seq_lengths"]
        pad_scale = lengths.shape[0] / (lengths > 0).sum().clamp(min=1).to(torch.float32)
    with span("train.forward"):
        out, _ = model(batch, None, generator)
    with span("train.loss"):
        total, vals = model.compute_loss(batch, out)
        vals = {k: v * pad_scale for k, v in vals.items()}
        loss = total * pad_scale
        if isinstance(model, IterativeErrorFeedback) and match_reference_grads:
            loss = loss + model.reference_grad_extra_loss(out) * pad_scale
    return loss, vals


def make_optimizer(model, config) -> torch.optim.Adam:
    """Adam over ``model``'s parameters at ``config.lr`` (optax's ``adam``)."""
    return torch.optim.Adam(model.parameters(), lr=config.lr, eps=1e-8)


def backward_step(model, pre, opt, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator], pad_scale: Optional[torch.Tensor] = None,
                  match_reference_grads: bool = True) -> Dict[str, torch.Tensor]:
    """The gradient half of an optimizer step: ``pre`` synthesizes the
    training batch from ``batch`` (``mode="all"``), then :func:`train_loss`
    and its gradients into the parameters' ``.grad`` (``opt``'s cleared
    first). Returns the loss values as device scalars; ``opt.step()``
    completes the step."""
    model.train()
    with span("train.synthesis"):
        synthesized = pre(batch, generator, mode="all")
    loss, vals = train_loss(model, synthesized, generator, pad_scale, match_reference_grads)
    del synthesized   # not held through the backward, which would raise the memory peak
    with span("train.backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    return {k: v.detach() for k, v in vals.items()}


def data_parallel_batch(host_batch: Dict, rank: int, world: int, device):
    """Rank ``rank``'s part of a data-parallel step on the global
    ``host_batch``: its rows of the batch padded to a multiple of ``world``,
    the :class:`parallel.mesh.Shard` its draws and BatchNorm statistics take,
    and the global batch's ``pad_scale`` (padded rows over real samples)."""
    padded = M.pad_batch_to_devices(host_batch, world)
    n_padded = padded["poses"].shape[0]
    n_valid = int((np.asarray(padded["seq_lengths"]) > 0).sum())
    pad_scale = n_padded / torch.tensor(float(max(n_valid, 1)), device=device)
    shard = M.Shard(rank, world, host_batch["poses"].shape[0], n_padded)
    return M.shard_batch(padded, rank, world), shard, pad_scale


class Trainer:
    """Model, optimizer, data synthesis and the random stream of one run.

    :param device: None = CUDA (raises without it); ``"cpu"`` for tests.
      In a process group (``parallel/mesh.init_distributed``) the trainer is
      this rank's, and ``config.dp_devices`` > 1 must equal the world size.
    """

    def __init__(self, config, seed: Optional[int] = None, match_reference_grads: bool = True,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        set_precision(_precision(config))
        self.data_parallel = M.distributed()
        self.rank = dist.get_rank() if self.data_parallel else 0
        self.world = dist.get_world_size() if self.data_parallel else 1
        n_dp = max(1, int(getattr(config, "dp_devices", 1)))
        if n_dp > 1 and n_dp != self.world:
            raise ValueError(f"--dp_devices {n_dp} trains in {n_dp} processes: start them with "
                             "python -m empose_tpu_torch.train, or join this process to a "
                             f"group of {n_dp} (parallel.mesh.init_distributed); this process "
                             f"is one of {self.world}")
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
        self.opt = make_optimizer(self.model, config)
        self.global_step = 0
        self.epoch = 0
        self.best_test_loss = float("inf")

    def upload(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch (numpy) -> tensors on the device; lengths as int64."""
        return to_device(host_batch, self.device)

    def loss(self, batch: Dict[str, torch.Tensor], pad_scale: Optional[torch.Tensor] = None):
        """:func:`train_loss` of this trainer's model, with its generator's
        dropout (a data-parallel step passes the global ``pad_scale``)."""
        return train_loss(self.model, batch, self.generator, pad_scale,
                          self.match_reference_grads)

    def train_step(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``host_batch`` (in a process group: the
        global batch, of which this rank keeps its rows); returns the loss
        values as device scalars (in a group, their means over the ranks).

        Spans (``utils/profiling.span``): ``train.step`` around the step,
        ``train.upload``, ``train.synthesis``, ``train.forward``,
        ``train.loss``, ``train.backward`` and ``train.optimizer`` inside it;
        a group's gradient average lies in ``train.step`` alone."""
        with span("train.step"):
            self.model.train()
            shard = pad_scale = None
            if self.data_parallel:
                host_batch, shard, pad_scale = data_parallel_batch(host_batch, self.rank,
                                                                   self.world, self.device)
            with M.shard_scope(shard):
                with span("train.upload"):
                    batch = self.upload(host_batch)
                vals = backward_step(self.model, self.pre_train, self.opt, batch, self.generator,
                                     pad_scale, self.match_reference_grads)
                del batch   # not held through Adam's step, which would raise the memory peak
            if shard is not None:
                M.average_gradients(self.model.parameters(), self.world)
                vals = M.mean_over_ranks(vals, self.world)
            with span("train.optimizer"):
                self.opt.step()
            self.global_step += 1
        return vals

    def train_step_chunk(self, host_batches) -> Dict[str, torch.Tensor]:
        """K training steps, one :meth:`train_step` per batch, so the losses
        and weights equal K single steps bit for bit; returns the loss
        values with a leading K axis (scalars for K = 1, as the JAX
        ``train_step_chunk``)."""
        if len(host_batches) == 1:
            return self.train_step(host_batches[0])
        vals = [self.train_step(b) for b in host_batches]
        return {k: torch.stack([v[k] for v in vals]) for k in vals[0]}

    def barrier(self) -> None:
        """Wait for every rank (nothing without a group)."""
        if self.data_parallel:
            dist.barrier()

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

    Up to ``steps_per_call`` batches go to ``trainer.train_step_chunk`` at a
    time; a chunk ends where a step prints, evaluates or reaches
    ``max_steps``, and before a batch of another shape, so those fire at the
    steps of ``steps_per_call`` 1 (as the JAX ``fit`` cuts its chunks). Loss
    values stay on the device until a print, an eval, ``max_steps`` or the
    end. A run that has steps already (``--resume``) fast-forwards the
    loader's random streams past them, so it sees the batches an
    uninterrupted run would. In a process group rank 0 alone prints,
    evaluates and saves, and the others wait for it.
    """
    config = trainer.config
    lead = trainer.rank == 0
    n_batches = len(train_loader)
    me = MetricsEngine(trainer.smplh, trainer.device)
    checkpoint_dir = os.path.join(model_dir, "checkpoint")
    start_epoch, start_i = divmod(trainer.global_step, n_batches)
    if trainer.global_step:
        train_loader.fast_forward(trainer.global_step)
    timer = StepTimer()
    unroll = max(int(getattr(config, "steps_per_call", 1) or 1), 1)
    print_mod = max(config.print_every - 1, 1)
    eval_mod = max(config.eval_every - 1, 1)
    last_vals: Dict[str, float] = {}
    pending = []  # (global step after the chunk, device loss dict, K) since the last flush
    chunk = []
    steps_in_window = 0

    def flush():
        nonlocal last_vals
        if not pending:
            return
        names = list(pending[0][1])
        rows = torch.cat([torch.stack([v[k].reshape(-1) for k in names], dim=-1)
                          for _, v, _ in pending]).tolist()
        pos = 0
        for gs_last, _, k_steps in pending:
            for j in range(k_steps):
                last_vals = dict(zip(names, rows[pos + j]))
                if writer:
                    gs = gs_last - (k_steps - 1 - j)
                    writer.add_scalars(last_vals, gs, prefix="train/")
                    writer.add_scalar("lr", config.lr, gs)
            pos += k_steps
        pending.clear()

    def run_chunk():
        nonlocal steps_in_window
        if not chunk:
            return
        vals = trainer.train_step_chunk(list(chunk))
        pending.append((trainer.global_step, vals, len(chunk)))
        steps_in_window += len(chunk)
        chunk.clear()

    def shapes(b):
        return {k: np.shape(v) for k, v in b.items() if k != "ids"}

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

    def finish() -> Dict[str, float]:
        flush()
        if lead and not os.path.isdir(checkpoint_dir):
            trainer.save(model_dir)
        trainer.barrier()
        return last_vals

    for epoch in range(start_epoch, config.n_epochs):
        trainer.epoch = epoch
        for i, batch in enumerate(train_loader, start=start_i if epoch == start_epoch else 0):
            if chunk and shapes(batch) != shapes(chunk[0]):
                run_chunk()
            chunk.append(batch)
            gs_after = trainer.global_step + len(chunk)
            at_print = i % print_mod == 0
            at_eval = gs_after % eval_mod == 0
            at_max = max_steps is not None and gs_after >= max_steps
            if len(chunk) >= unroll or at_print or at_eval or at_max:
                run_chunk()
            if at_print:
                flush()
                per_step = timer.reset() / max(steps_in_window, 1)
                steps_in_window = 0
                if lead:
                    loss_string = " ".join(f"{k}: {v:.6f}" for k, v in last_vals.items())
                    print(f"[TRAIN {i + 1:05d} | {epoch + 1:03d}] {loss_string} "
                          f"elapsed: {per_step:.3f} secs", flush=True)
            if at_eval:
                flush()
                if lead:
                    evaluate(i, epoch)
                trainer.barrier()
                # Eval time is not billed to the next print window's steps.
                timer.reset()
                steps_in_window = 0
            if max_steps is not None and trainer.global_step >= max_steps:
                return finish()
    run_chunk()
    return finish()
