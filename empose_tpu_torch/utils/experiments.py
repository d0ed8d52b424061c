"""Experiment directories and model loading for the port.

``get_model_dir``, ``create_model_dir``, ``zip_files`` and ``save_cmd`` are
the port's own copies of ``empose_tpu/utils/experiments.py``
(``<experiment_dir>/<model_id>-<summary>``). ``load_model`` follows
``empose_tpu/eval/harness.py::load_model``: ``config.json`` plus a
reference-layout ``model.pth`` (``{"model_state_dict": ...}``).
"""

from __future__ import annotations

import glob
import os
import sys
import zipfile
from typing import Optional

import torch
from torch import nn

from empose_tpu_torch import constants as C
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import disable_tf32, resolve_device


def get_model_dir(experiment_dir: str, model_id) -> Optional[str]:
    matches = glob.glob(os.path.join(experiment_dir, str(model_id) + "-*"))
    return None if not matches else matches[0]


def create_model_dir(experiment_dir: str, experiment_id, model_summary: str,
                     other_summary: Optional[str] = None) -> str:
    model_name = f"{experiment_id}-{model_summary}"
    if other_summary:
        model_name = f"{model_name}-{other_summary}"
    model_dir = os.path.join(experiment_dir, model_name)
    if os.path.exists(model_dir):
        raise ValueError(f"Model directory already exists {model_dir}")
    os.makedirs(model_dir)
    return model_dir


def zip_files(file_list, output_file: str) -> str:
    """Zip ``file_list`` into ``output_file`` (``_1``, ``_2``, ... if taken)."""
    if not output_file.endswith(".zip"):
        output_file += ".zip"
    ofile = output_file
    counter = 0
    while os.path.exists(ofile):
        counter += 1
        ofile = output_file.replace(".zip", f"_{counter}.zip")
    with zipfile.ZipFile(ofile, mode="w", compression=zipfile.ZIP_DEFLATED) as zf:
        for f in file_list:
            zf.write(f)
    return ofile


def save_cmd(model_dir: str) -> None:
    """The command line of this process, into ``cmd.txt``."""
    with open(os.path.join(model_dir, "cmd.txt"), "w") as f:
        f.write(sys.argv[0] + " " + " ".join(sys.argv[1:]))


def count_parameters(model: nn.Module) -> int:
    """Number of trainable scalars."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def load_model(model_id, experiment_dir: Optional[str] = None, device=None):
    """Rebuild a model from its experiment dir, in eval mode on ``device``
    (None = CUDA), with TF32 off; its products run at the precision knobs'
    mode (``device.set_precision``, ``highest`` unless set). The SMPL-H
    model comes from ``$SMPL_MODELS``.

    :return: (model, config, model_dir)
    """
    from empose_tpu_torch.bodymodel.smplh import load_smplh
    from empose_tpu_torch.nn.models import SensorSMPL, create_model

    dev = resolve_device(device)
    disable_tf32()
    experiment_dir = experiment_dir or C.experiment_dir()
    model_dir = get_model_dir(experiment_dir, model_id)
    if model_dir is None:
        raise FileNotFoundError(f"No experiment dir for model id {model_id} in {experiment_dir}")
    ckpt_file = os.path.join(model_dir, "model.pth")
    if not os.path.exists(ckpt_file):
        if os.path.isdir(os.path.join(model_dir, "checkpoint_model")):
            raise FileNotFoundError(
                f"{model_dir} holds only a native JAX checkpoint (checkpoint_model/); "
                f"export it first with `python tools/export_torch.py --model_id {model_id}`")
        raise FileNotFoundError(f"No model.pth in {model_dir}")
    config = Configuration.from_json(os.path.join(model_dir, "config.json"))
    model = create_model(config, SensorSMPL(load_smplh()))
    checkpoint = torch.load(ckpt_file, map_location="cpu", weights_only=True)
    model.load_state_dict(checkpoint["model_state_dict"], strict=True)
    print(f"Model created with {count_parameters(model)} trainable parameters", file=sys.stderr)
    return model.to(dev).eval(), config, model_dir
