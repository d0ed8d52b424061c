"""The matmul precision modes' names (``empose_tpu/utils/precision.py``).

Two knobs read them: ``nn.layers.set_nn_precision`` (the NN GEMMs and the
LSTM kernels) and ``nn.models.set_fk_precision`` (the kinematics GEMMs of
``SensorSMPL.markers_and_joints``); ``device.set_precision`` sets both. Both
resolve names through this table, so modes and errors stay in sync.
"""

from __future__ import annotations

HIGHEST = "highest"  # fp32 products, TF32 off: the parity mode
HIGH = "high"        # three bf16 products accumulated in f32 (bf16_3x)
DEFAULT = "default"  # bf16 inputs, f32 accumulation and output: the bf16 serving mode

PRECISIONS = {"highest": HIGHEST, "high": HIGH, "default": DEFAULT}


def resolve(name: str) -> str:
    try:
        return PRECISIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision {name!r}; choose from {sorted(PRECISIONS)}")
