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
once more, with their metric tables.
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
from empose_tpu_torch.data.datasets import EMRBatchLoader, Loader, RealDataset
from empose_tpu_torch.eval.metrics import MetricsEngine
from empose_tpu_torch.train.loop import Trainer, fit
from empose_tpu_torch.utils import experiments as U
from empose_tpu_torch.utils.logging import ScalarWriter

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def experiment_name(trainer: Trainer, config) -> str:
    name = trainer.model.model_name()
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


def run(config, max_steps=None, device=None):
    """Train per ``config``; returns ``(model_dir, trainer)``."""
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

    experiment_id = config.experiment_id
    if experiment_id is None:
        experiment_id = int(time.time())
        model_dir = U.create_model_dir(C.experiment_dir(), experiment_id,
                                       experiment_name(trainer, config))
    else:
        model_dir = U.get_model_dir(C.experiment_dir(), experiment_id)
        if config.load or config.resume:
            if model_dir is None or not os.path.exists(model_dir):
                raise ValueError(f"Cannot find model directory for experiment ID {experiment_id}")
        else:
            if model_dir is not None:
                raise ValueError(f"Model directory for experiment ID {experiment_id} already "
                                 "exists. Did you mean to use --load?")
            model_dir = U.create_model_dir(C.experiment_dir(), experiment_id,
                                           experiment_name(trainer, config))

    U.zip_files(glob.glob(os.path.join(_PKG_DIR, "**", "*.py"), recursive=True),
                os.path.join(model_dir, "code.zip"))
    config.to_json(os.path.join(model_dir, "config.json"))
    U.save_cmd(model_dir)

    if config.resume and os.path.isdir(os.path.join(model_dir, "checkpoint")):
        trainer.restore(model_dir)
        print(f"Resumed from step {trainer.global_step} (epoch {trainer.epoch})")
    print(f"Model created with {U.count_parameters(trainer.model)} trainable parameters")
    print(f"Saving checkpoints to {os.path.join(model_dir, 'checkpoint')}")

    writer = ScalarWriter(os.path.join(model_dir, "logs"))
    try:
        fit(trainer, train_loader, valid_loader, test_loader, model_dir, writer,
            max_steps=max_steps)
    finally:
        writer.close()

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


def main(argv=None):
    parser = Configuration.parser()
    parser.add_argument("--device", default=None, help="cuda (default) or cpu.")
    parser.add_argument("--max_steps", type=int, default=None, help="Stop after this many steps.")
    args = vars(parser.parse_args(argv))
    device, max_steps = args.pop("device"), args.pop("max_steps")
    return run(Configuration(args), max_steps=max_steps, device=device)
