"""Device resolution and the matmul precision of the port's entry points.

Entry points take ``device=None``, which means CUDA. CUDA asked for and
absent raises; only an explicit ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """TF32 off for matmuls and cuDNN (TF32 is not JAX's HIGH), and f32 sums
    in cuBLAS's bf16 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def set_precision(name: str = "highest") -> None:
    """Bind the matmul precision of serving and evaluation, as
    ``scripts/serve.py:_set_precision`` does: the NN knob
    (``nn.layers.set_nn_precision``) and the kinematics knob
    (``nn.models.set_fk_precision``) together. ``highest`` is fp32, the JAX
    package's parity mode; ``high`` the bf16_3x product; ``default`` bf16
    inputs with f32 sums (``ops/precision.py``). TF32 stays off at every
    mode (TF32 is not JAX's HIGH), and cuBLAS keeps f32 sums in its bf16
    products. Raises ValueError for an unknown name."""
    from empose_tpu_torch.nn.layers import set_nn_precision
    from empose_tpu_torch.nn.models import set_fk_precision
    from empose_tpu_torch.utils.precision import resolve

    mode = resolve(name)
    disable_tf32()
    set_nn_precision(mode)
    set_fk_precision(mode)


@contextlib.contextmanager
def precision_scope(name: Optional[str]):
    """Both knobs at ``name`` inside the block (as :func:`set_precision`),
    each restored after; ``None`` leaves them as they are."""
    if name is None:
        yield
        return
    from empose_tpu_torch.nn.layers import nn_precision, set_nn_precision
    from empose_tpu_torch.nn.models import fk_precision, set_fk_precision
    nn_mode, fk_mode = nn_precision(), fk_precision()
    set_precision(name)
    try:
        yield
    finally:
        set_nn_precision(nn_mode)
        set_fk_precision(fk_mode)
