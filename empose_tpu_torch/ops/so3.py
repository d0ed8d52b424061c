"""The SO(3) map the SMPL-H forward kinematics needs, in torch.

The smplx Rodrigues of ``empose_tpu/bodymodel/smplh.py::rodrigues`` (the
angle-axis -> rotation map FK uses); the rest of ``empose_tpu/ops/so3.py``
comes with the evaluation slice. Arbitrary leading batch dimensions,
differentiable.
"""

from __future__ import annotations

import torch


def rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), smplx convention:
    the angle is ``||aa + 1e-8||`` (a constant added to the components, not a
    clamp), as the SMPL-H body model uses it."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir.unbind(-1)
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1)
    K = K.reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)
