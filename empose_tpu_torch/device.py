"""Device resolution and the fp32 parity mode for the port's entry points.

Entry points take ``device=None``, which means CUDA. CUDA asked for and
absent raises; only an explicit ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest",)


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


def set_precision(name: str = "highest") -> None:
    """Bind the matmul precision. Only ``highest`` exists in the port: fp32
    with TF32 off for matmuls and cuDNN, the JAX package's parity mode."""
    if name not in PRECISIONS:
        raise ValueError(
            f"precision {name!r} is not ported yet: the port runs only "
            "'highest' (fp32, TF32 off); 'high' and 'default' are an open "
            "item of ROADMAP.md ('Precision modes')")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
