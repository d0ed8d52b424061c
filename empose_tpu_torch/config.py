"""Run configuration: CLI flags <-> JSON round-trip.

The port's own copy of ``empose_tpu/config.py``: the same flag table and
field names, so a ``config.json`` written by the JAX package or the
reference reconstructs the same model here. The JAX package's own additions
stay in the table (configs it writes carry them) and keep their defaults.
"""

from __future__ import annotations

import argparse
import json
import pprint
from typing import Any, Dict


# (name, default, kwargs-for-argparse)
_FLAG_SPECS = [
    # General.
    ("experiment_id", None, dict(help="Use this experiment ID or create a new one.")),
    ("seed", None, dict(type=int, help="Random generator seed.")),
    ("data_workers", 4, dict(type=int, help="Number of parallel threads for data loading.")),
    ("print_every", 25, dict(type=int, help="Print stats to console every so many iters.")),
    ("eval_every", 700, dict(type=int, help="Evaluate validation set every so many iters.")),
    ("tag", "", dict(help="A custom tag for this experiment.")),
    ("test", False, dict(action="store_true", help="Will tag this run as a test run.")),
    # Model configurations.
    ("m_type", "rnn", dict(choices=["rnn", "resnet", "ief", "lgd"], help="The type of model.")),
    ("m_estimate_shape", False, dict(action="store_true", help="The model estimates the body shape.")),
    # NOTE: the reference omits type=int here (configuration.py:162), so the
    # flag silently arrives as a string from its CLI; fixed here.
    ("m_shape_hidden_size", 256, dict(type=int, help="Size of the network estimating the shape.")),
    ("m_fk_loss", 0.0, dict(type=float, help="Add an FK loss, requires shape estimate.")),
    ("m_dropout", 0.0, dict(type=float, help="Dropout applied on inputs.")),
    ("m_hidden_size", 1024, dict(type=int, help="Number of hidden units.")),
    ("m_num_layers", 2, dict(type=int, help="Number of layers.")),
    ("m_learn_init_state", False, dict(action="store_true", help="Learn initial hidden state.")),
    ("m_bidirectional", False, dict(action="store_true", help="Bidirectional RNN.")),
    # IEF model specific.
    ("m_num_iterations", 4, dict(type=int, help="Number of iterations for IEF.")),
    ("m_dropout_hidden", 0.0, dict(type=float, help="Dropout applied inside layers.")),
    ("m_step_size", 0.1, dict(type=float, help="Step size for IEF update.")),
    ("m_reprojection_loss_weight", 0.01, dict(type=float, help="Reprojection loss weight.")),
    ("m_shape_loss_weight", 1.0, dict(type=float, help="Loss weight for the shape.")),
    ("m_pose_loss_weight", 1.0, dict(type=float, help="Loss weight for the pose.")),
    ("m_average_shape", False, dict(action="store_true", help="Average the shape per sequence.")),
    ("m_use_gradient", False, dict(action="store_true", help="Feed dL/dtheta to the network.")),
    ("m_skip_connections", False, dict(action="store_true", help="Skip connections in the MLP.")),
    ("m_no_batch_norm", False, dict(action="store_true", help="Don't use batch norm.")),
    ("m_rnn_init", False, dict(action="store_true", help="Initial estimate is provided by an RNN.")),
    ("m_rnn_denoiser", False, dict(action="store_true", help="Use an RNN to de-noise the markers.")),
    ("m_rnn_bidirectional", False, dict(action="store_true", help="BiRNN or not.")),
    ("m_rnn_hidden_size", 512, dict(type=int, help="Hidden size for the init RNN.")),
    ("m_rnn_num_layers", 2, dict(type=int, help="Number of layers for the init RNN.")),
    # Input data.
    ("use_marker_pos", False, dict(action="store_true", help="Feed marker positions.")),
    ("use_marker_ori", False, dict(action="store_true", help="Feed marker orientations.")),
    ("use_marker_nor", False, dict(action="store_true", help="Feed marker normal instead of orientation.")),
    ("use_real_offsets", False, dict(action="store_true", help="Sampling is informed by real offset distribution.")),
    ("offset_noise_level", 0, dict(type=int, help="How much noise to add to real offsets.")),
    ("n_markers", 12, dict(type=int, help="Subselect a number of markers for the input.")),
    # Data augmentation.
    ("noise_num_markers", 1, dict(type=int, help="How many markers are affected by the noise.")),
    ("spherical_noise_strength", 0.0, dict(type=float, help="Magnitude of noise in %.")),
    ("spherical_noise_length", 0.0, dict(type=float, help="Temporal length of noise in %.")),
    ("suppression_noise_length", 0.0, dict(type=float, help="Marker suppression length.")),
    ("suppression_noise_value", 0.0, dict(type=float, help="Marker suppression value.")),
    # Learning configurations.
    ("lr", 0.001, dict(type=float, help="Learning rate.")),
    ("n_epochs", 50, dict(type=int, help="Number of epochs.")),
    ("bs_train", 16, dict(type=int, help="Batch size for the training set.")),
    ("bs_eval", 16, dict(type=int, help="Batch size for valid/test set.")),
    ("eval_window_size", None, dict(type=int, help="Window size for evaluation on test set.")),
    ("window_size", 120, dict(type=int, help="Number of frames to extract per sequence.")),
    ("load", False, dict(action="store_true", help="Whether to load the model with the given ID.")),
    # TPU-native additions (absent from reference configs; defaults keep parity).
    ("dp_devices", 1, dict(type=int, help="Data-parallel device count (shard_map over a 1D mesh).")),
    ("bf16", False, dict(action="store_true", help="Run matmuls in bfloat16 where safe "
                                                   "(alias for --matmul_precision default).")),
    ("matmul_precision", "highest", dict(choices=("highest", "high", "default"),
                                         help="NN + lane-FK GEMM precision: 'highest' = "
                                              "f32-on-MXU torch-parity mode; 'high' = "
                                              "3-pass bf16 (near-f32-exact, ~2x MXU "
                                              "throughput, same parity tolerances on the "
                                              "validated battery); 'default' = bf16-input "
                                              "fast mode.")),
    ("resume", False, dict(action="store_true", help="Resume full training state from the latest checkpoint.")),
    ("profile_dir", None, dict(help="If set, capture a torch.profiler trace into this directory.")),
    ("remat", False, dict(action="store_true", help="Rematerialize FK inside the LGD loop "
                                                    "(trades FLOPs for training memory).")),
    ("steps_per_call", 8, dict(type=int, help="Host-loop unrolling: run up to K training "
                                              "steps as one device program (lax.scan), "
                                              "amortizing per-step host/dispatch cost. "
                                              "Same per-step math and PRNG chain as K=1 "
                                              "(bit-identical on CPU; on TPU equal up to "
                                              "XLA fusion-order rounding). Print/eval "
                                              "cadence is preserved exactly.")),
]


class Configuration:
    """A plain attribute bag with argparse/JSON round-trip."""

    def __init__(self, adict: Dict[str, Any]):
        # Backfill defaults so configs written by older versions (or the
        # reference) still construct models (new flags default harmlessly).
        merged = {name: default for name, default, _ in _FLAG_SPECS}
        merged.update(adict)
        self.__dict__.update(merged)

    def __str__(self) -> str:
        return pprint.pformat(vars(self), indent=4)

    def __contains__(self, k: str) -> bool:
        return k in self.__dict__

    @staticmethod
    def parser() -> argparse.ArgumentParser:
        parser = argparse.ArgumentParser()
        for name, default, kwargs in _FLAG_SPECS:
            parser.add_argument(f"--{name}", default=default, **kwargs)
        return parser

    @staticmethod
    def parse_cmd(argv=None) -> "Configuration":
        config = Configuration.parser().parse_args(argv)
        return Configuration(vars(config))

    @staticmethod
    def from_json(json_path: str) -> "Configuration":
        with open(json_path, "r") as f:
            return Configuration(json.load(f))

    @staticmethod
    def from_dict(adict: Dict[str, Any]) -> "Configuration":
        return Configuration(dict(adict))

    def to_json(self, json_path: str) -> None:
        with open(json_path, "w") as f:
            f.write(json.dumps(vars(self), indent=2, sort_keys=True, default=str))
