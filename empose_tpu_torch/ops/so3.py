"""SO(3) maps in torch.

The smplx Rodrigues of ``empose_tpu/bodymodel/smplh.py::rodrigues`` (the
angle-axis -> rotation map FK uses), and the clamped exponential and log
maps of ``empose_tpu/ops/so3.py`` (``aa2rot``/``rot2aa``) that root
normalization uses, with ``so3_relative_angle`` and ``local_to_global`` of
the same module for the angular metric. The two exponential maps are not
interchangeable: the smplx one adds 1e-8 to the components, the other clamps
the squared angle at ``eps``. Arbitrary leading batch dimensions,
differentiable.
"""

from __future__ import annotations

from typing import Sequence

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


def hat(v: torch.Tensor) -> torch.Tensor:
    """Vectors (..., 3) -> skew-symmetric matrices (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(v.shape + (3,))


def hat_inv(h: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (..., 3, 3) -> (..., 3); no symmetry check."""
    return torch.stack([h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]], dim=-1)


def so3_rotation_angle(R: torch.Tensor, cos_angle: bool = False) -> torch.Tensor:
    """Rotation angle of (..., 3, 3) rotation matrices (trace clamped to [-1, 3])."""
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]).clamp(-1.0, 3.0)
    phi = 0.5 * (trace - 1.0)
    return phi if cos_angle else torch.arccos(phi)


def so3_exponential_map(log_rot: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3); the squared angle
    is clamped at ``eps`` before the square root."""
    nrms = (log_rot * log_rot).sum(-1)
    angles = nrms.clamp(min=eps).sqrt()
    inv = 1.0 / angles
    fac1 = inv * torch.sin(angles)
    fac2 = inv * inv * (1.0 - torch.cos(angles))
    skews = hat(log_rot)
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device)
    return fac1[..., None, None] * skews + fac2[..., None, None] * (skews @ skews) + eye


def so3_log_map(R: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> angle-axis (..., 3)."""
    phi = so3_rotation_angle(R)
    phi_sin = torch.sin(phi)
    phi_denom = (phi_sin.abs().clamp(min=eps) * torch.sign(phi_sin)
                 + (phi_sin == 0).to(phi.dtype) * eps)
    log_rot_hat = (phi / (2.0 * phi_denom))[..., None, None] * (R - R.transpose(-1, -2))
    return hat_inv(log_rot_hat)


aa2rot = so3_exponential_map
rot2aa = so3_log_map


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor, cos_angle: bool = False) -> torch.Tensor:
    """Geodesic angle between rotation matrices (..., 3, 3): the angle of
    ``R1 R2^T``."""
    return so3_rotation_angle(R1 @ R2.transpose(-1, -2), cos_angle=cos_angle)


def local_to_global(poses: torch.Tensor, parents: Sequence[int], output_format: str = "aa",
                    input_format: str = "aa") -> torch.Tensor:
    """Relative joint rotations -> global rotations along a kinematic tree.

    :param poses: (..., J * 3) angle-axis ('aa') or (..., J * 9) rotation
      matrices ('rotmat'); :param parents: static parent per joint, -1 at
      the root (a parent precedes its children).
    :return: (..., J * 3) for 'aa', (..., J * 9) for 'rotmat'.
    """
    if output_format not in ("aa", "rotmat") or input_format not in ("aa", "rotmat"):
        raise ValueError(f"formats must be 'aa' or 'rotmat', got {input_format!r} -> "
                         f"{output_format!r}")
    dof = 3 if input_format == "aa" else 9
    n_joints = poses.shape[-1] // dof
    batch = poses.shape[:-1]
    if input_format == "aa":
        local = so3_exponential_map(poses.reshape(batch + (n_joints, 3)))
    else:
        local = poses.reshape(batch + (n_joints, 3, 3))
    glob = []
    for j in range(n_joints):
        p = parents[j]
        glob.append(local[..., j, :, :] if p < 0 else glob[p] @ local[..., j, :, :])
    glob = torch.stack(glob, dim=-3)
    if output_format == "aa":
        return so3_log_map(glob).reshape(batch + (n_joints * 3,))
    return glob.reshape(batch + (n_joints * 9,))
