"""Train an EM-POSE model on synthetic AMASS-style data with the port.

    python -m empose_tpu_torch.train --m_type lgd --m_rnn_init --m_use_gradient ... \
        [--device cpu] [--max_steps K]

Port of ``scripts/train.py``: the same flags (``empose_tpu_torch/config.py``)
plus ``--device`` (default: CUDA, raises without it) and ``--max_steps``;
the same experiment directory (``<id>-<model name>`` with ``config.json``,
``cmd.txt``, ``code.zip``, ``logs/``, ``checkpoint/``) and ``model.pth``;
``--load``/``--resume``, and a ``ValueError`` on an existing id without
either. Validation runs on the 3DPW-style corpus of $EM_DATA_SYNTH (middle
windows), the test on the real recordings of $EM_DATA_REAL; after training,
the best checkpoint (the last where no eval fired) goes through both passes
once more, with their metric tables. ``--profile_dir DIR`` records the
training (``fit``, not the final passes) as a ``torch.profiler`` Chrome
trace in DIR (``utils/profiling.trace``). ``--steps_per_call K`` hands up
to K steps at a time to the trainer (``train/loop.py``, same steps bit for
bit). ``--dp_devices N`` trains in N spawned processes, rank r on the r-th
CUDA card with NCCL, or N gloo ranks with ``--device cpu``
(:func:`run_data_parallel`); it raises ``ValueError`` before any step where
there are fewer cards, and fails where any rank fails.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.batches import collate_real
from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.data.datasets import EMRBatchLoader, Loader, RealDataset
from empose_tpu_torch.eval.metrics import MetricsEngine
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import cuda_build
from empose_tpu_torch.parallel.mesh import make_mesh, spawn
from empose_tpu_torch.train.loop import Trainer, fit
from empose_tpu_torch.utils import experiments as U
from empose_tpu_torch.utils.logging import ScalarWriter
from empose_tpu_torch.utils.profiling import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def experiment_name(model, config) -> str:
    name = model.model_name()
    name += "{}{}{}".format("-pos" if config.use_marker_pos else "",
                            "-ori" if config.use_marker_ori else "",
                            "-nor" if config.use_marker_nor else "")
    if config.suppression_noise_length > 0.0:
        name += f"-noise-supp-{config.suppression_noise_length}"
    if config.spherical_noise_strength > 0.0:
        name += f"-noise-spher-{config.spherical_noise_strength}"
    if config.test:
        name += "--TEST"
    return name


def prepare_experiment(config, name: str):
    """The experiment directory of ``config.experiment_id`` (a new one named
    ``<id>-<name>``, or the existing one for ``--load``/``--resume``) with
    ``code.zip``, ``config.json`` and ``cmd.txt``; returns ``(model_dir, id)``."""
    experiment_id = config.experiment_id
    if experiment_id is None:
        experiment_id = int(time.time())
        model_dir = U.create_model_dir(C.experiment_dir(), experiment_id, name)
    else:
        model_dir = U.get_model_dir(C.experiment_dir(), experiment_id)
        if config.load or config.resume:
            if model_dir is None or not os.path.exists(model_dir):
                raise ValueError(f"Cannot find model directory for experiment ID {experiment_id}")
        else:
            if model_dir is not None:
                raise ValueError(f"Model directory for experiment ID {experiment_id} already "
                                 "exists. Did you mean to use --load?")
            model_dir = U.create_model_dir(C.experiment_dir(), experiment_id, name)

    U.zip_files(glob.glob(os.path.join(_PKG_DIR, "**", "*.py"), recursive=True),
                os.path.join(model_dir, "code.zip"))
    config.to_json(os.path.join(model_dir, "config.json"))
    U.save_cmd(model_dir)
    return model_dir, experiment_id


def run(config, max_steps=None, device=None, experiment=None):
    """Train per ``config``; returns ``(model_dir, trainer)``.

    :param experiment: ``(model_dir, id)`` prepared already (the ranks of a
      data-parallel run); None prepares it here.
    """
    if config.seed is None:
        config.seed = int(time.time())
    # Crops draw from a dedicated extractor stream seeded 4313, the shuffle
    # from config.seed, as in the JAX package.
    train_loader = EMRBatchLoader(os.path.join(C.data_dir_synth(), "amass_emr"),
                                  config.bs_train, config.window_size, shuffle=True,
                                  seed=config.seed, window_mode="random",
                                  window_rng=np.random.RandomState(4313), prefetch=2)
    valid_loader = EMRBatchLoader(os.path.join(C.data_dir_synth(), "3dpw_emr"),
                                  config.bs_eval, config.window_size, shuffle=False,
                                  window_mode="middle", prefetch=2)
    test_loader = Loader(RealDataset(C.data_dir_real()), 1, collate_real, shuffle=False)
    trainer = Trainer(config, device=device)
    lead = trainer.rank == 0
    model_dir, experiment_id = experiment or prepare_experiment(
        config, experiment_name(trainer.model, config))

    if config.resume and os.path.isdir(os.path.join(model_dir, "checkpoint")):
        trainer.restore(model_dir)
        if lead:
            print(f"Resumed from step {trainer.global_step} (epoch {trainer.epoch})")
    if lead:
        print(f"Model created with {U.count_parameters(trainer.model)} trainable parameters")
        print(f"Saving checkpoints to {os.path.join(model_dir, 'checkpoint')}")

    writer = ScalarWriter(os.path.join(model_dir, "logs")) if lead else None
    try:
        with trace(config.profile_dir if lead else None):
            fit(trainer, train_loader, valid_loader, test_loader, model_dir, writer,
                max_steps=max_steps)
    finally:
        if writer:
            writer.close()
    if not lead:
        return model_dir, trainer

    # The final passes run the best checkpoint's weights; the returned trainer
    # keeps the state that the run ended with.
    ended = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    best = torch.load(os.path.join(model_dir, "checkpoint", "train_state.pt"),
                      map_location="cpu", weights_only=True)["model"]
    trainer.model.load_state_dict(best)
    try:
        me = MetricsEngine(trainer.smplh, trainer.device)
        final_valid = trainer.evaluate_valid(valid_loader, me)
        print("[VALID FINAL] " + " ".join(f"{k}: {v:.6f}" for k, v in final_valid.items()))
        print(MetricsEngine.to_pretty_string(me.get_metrics(), experiment_id))
        final_test = trainer.evaluate_test(test_loader, me, config.eval_window_size)
        print("[TEST FINAL] " + " ".join(f"{k}: {v:.6f}" for k, v in final_test.items()))
        print(MetricsEngine.to_pretty_string(me.get_metrics(), experiment_id), flush=True)
    finally:
        trainer.model.load_state_dict(ended)
    return model_dir, trainer


def _rank(rank: int, device: torch.device, config, max_steps, experiment) -> None:
    """One rank of a data-parallel run (``parallel.mesh.spawn``)."""
    run(config, max_steps=max_steps, device=device, experiment=experiment)


def run_data_parallel(config, max_steps=None, device=None):
    """Train per ``config`` in ``config.dp_devices`` processes, rank r on the
    r-th CUDA card (NCCL), or every rank on the CPU (gloo) with
    ``device="cpu"``. Raises ``ValueError`` before any step where CUDA has
    fewer cards. Returns ``(model_dir, None)``: the trainers live in the
    ranks; rank 0 prints, evaluates and writes the checkpoint and logs."""
    devices = make_mesh(int(config.dp_devices), torch.device(device or "cuda").type)
    if config.seed is None:
        config.seed = int(time.time())  # one seed for every rank
    experiment = prepare_experiment(
        config, experiment_name(create_model(config, SensorSMPL(load_smplh())), config))
    if devices[0].type == "cuda":
        # Built once here, so that the ranks load the libraries and never race to build them.
        cuda_build.build(cuda_build.SOURCES)
    spawn(_rank, devices, config, max_steps, experiment)
    return experiment[0], None


def main(argv=None):
    parser = Configuration.parser()
    parser.add_argument("--device", default=None, help="cuda (default) or cpu.")
    parser.add_argument("--max_steps", type=int, default=None, help="Stop after this many steps.")
    args = vars(parser.parse_args(argv))
    device, max_steps = args.pop("device"), args.pop("max_steps")
    config = Configuration(args)
    if max(1, int(config.dp_devices or 1)) > 1:
        return run_data_parallel(config, max_steps=max_steps, device=device)
    return run(config, max_steps=max_steps, device=device)
