"""Quaternions: host numpy for offline resampling (conversions, sign
continuity, SLERP and SQUAD) and torch for the angular metric.

The port's own copy of ``empose_tpu/ops/quaternions.py``: the numpy half
(``np_quat_*``, ``fix_quaternions``, ``np_slerp``, ``squad``,
``resample_rotations``) with the same numpy arithmetic, so the same inputs
give the same bits, and ``quat_from_aa`` with
``rotation_intrinsic_distance_from_aa`` in torch. Quaternions are (..., 4)
in (w, x, y, z) order.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_from_aa(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> unit quaternions (..., 4), with the small-angle
    guard of the JAX version (sin(x)/x -> 1/2 below 1e-8)."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    small = angle < 1e-8
    sinc = torch.where(small, torch.full_like(angle, 0.5),
                       torch.sin(0.5 * angle) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(0.5 * angle), aa * sinc], dim=-1)


def rotation_intrinsic_distance_from_aa(aa1: torch.Tensor, aa2: torch.Tensor) -> torch.Tensor:
    """Geodesic distance (radians) between angle-axis rotations (..., 3):
    ``2 * arccos(clip(<q1, q2>, -1, 1))``. The dot product keeps its sign:
    the double cover is not collapsed, as in numpy-quaternion's
    ``rotation_intrinsic_distance`` that the reference metrics use."""
    dot = (quat_from_aa(aa1) * quat_from_aa(aa2)).sum(-1)
    return 2.0 * torch.arccos(dot.clamp(-1.0, 1.0))


def np_quat_from_aa(aa: np.ndarray) -> np.ndarray:
    """Angle-axis (..., 3) -> unit quaternions (..., 4)."""
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = 0.5 * angle
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(angle < 1e-12, 0.5, np.sin(half) / np.where(angle < 1e-12, 1.0, angle))
    return np.concatenate([np.cos(half), aa * sinc], axis=-1)


def np_quat_to_aa(q: np.ndarray) -> np.ndarray:
    """Quaternions (..., 4) -> angle-axis (..., 3)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w = np.clip(q[..., :1], -1.0, 1.0)
    angle = 2.0 * np.arccos(w)
    s = np.sqrt(np.maximum(1.0 - w * w, 0.0))
    axis = np.where(s < 1e-12, 0.0, q[..., 1:] / np.where(s < 1e-12, 1.0, s))
    return axis * angle


def np_quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def np_quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def np_quat_log(q: np.ndarray) -> np.ndarray:
    """Log of a unit quaternion -> pure quaternion (0, theta/2 * axis)."""
    w = np.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    angle = np.arctan2(vn, w)
    fac = np.where(vn < 1e-12, 0.0, angle / np.where(vn < 1e-12, 1.0, vn))
    out = np.zeros_like(q)
    out[..., 1:] = v * fac
    return out


def np_quat_exp(q: np.ndarray) -> np.ndarray:
    """Exp of a pure quaternion (0, v) -> unit quaternion."""
    v = q[..., 1:]
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    out = np.zeros_like(q)
    out[..., :1] = np.cos(vn)
    fac = np.where(vn < 1e-12, 1.0, np.sin(vn) / np.where(vn < 1e-12, 1.0, vn))
    out[..., 1:] = v * fac
    return out


def fix_quaternions(quats: np.ndarray) -> np.ndarray:
    """Sign continuity along the time (first) axis: (F, N, 4) -> same shape,
    each quaternion flipped where the running count of negative dot products
    with its predecessor is odd."""
    if quats.ndim != 3 or quats.shape[-1] != 4:
        raise ValueError(f"expected (F, N, 4) quaternions, got shape {quats.shape}")
    result = quats.copy()
    dot_products = np.sum(quats[1:] * quats[:-1], axis=2)
    mask = (np.cumsum(dot_products < 0, axis=0) % 2).astype(bool)
    result[1:][mask] *= -1
    return result


def np_slerp(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical linear interpolation between quaternion arrays; t in [0, 1]."""
    t = np.asarray(t)[..., None]
    dot = np.clip(np.sum(q0 * q1, axis=-1, keepdims=True), -1.0, 1.0)
    theta = np.arccos(dot)
    sin_theta = np.sin(theta)
    lin = np.abs(sin_theta) < 1e-7
    w0 = np.where(lin, 1.0 - t, np.sin((1.0 - t) * theta) / np.where(lin, 1.0, sin_theta))
    w1 = np.where(lin, t, np.sin(t * theta) / np.where(lin, 1.0, sin_theta))
    out = w0 * q0 + w1 * q1
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def squad(quats: np.ndarray, ts_in: np.ndarray, ts_out: np.ndarray) -> np.ndarray:
    """Spherical quadrangle (C1-continuous) interpolation of a quaternion track.

    :param quats: (F, 4) sign-continuous unit quaternions (``fix_quaternions``)
      at the increasing times ``ts_in`` (F,).
    :param ts_out: (G,) query times, clipped to the input range.
    :return: (G, 4) interpolated unit quaternions.
    """
    quats = np.asarray(quats, dtype=np.float64)
    ts_in = np.asarray(ts_in, dtype=np.float64)
    ts_out = np.clip(np.asarray(ts_out, dtype=np.float64), ts_in[0], ts_in[-1])
    f = quats.shape[0]
    if f == 1:
        return np.repeat(quats, len(ts_out), axis=0)

    # Inner control points per knot; the end knots are their own.
    q_prev = quats[np.maximum(np.arange(f) - 1, 0)]
    q_next = quats[np.minimum(np.arange(f) + 1, f - 1)]
    q_inv = np_quat_conj(quats)
    log_next = np_quat_log(np_quat_mul(q_inv, q_next))
    log_prev = np_quat_log(np_quat_mul(q_inv, q_prev))
    inner = np_quat_mul(quats, np_quat_exp(-0.25 * (log_next + log_prev)))
    inner[0] = quats[0]
    inner[-1] = quats[-1]

    # Segment and normalized parameter tau per query.
    idx = np.clip(np.searchsorted(ts_in, ts_out, side="right") - 1, 0, f - 2)
    t0, t1 = ts_in[idx], ts_in[idx + 1]
    tau = np.where(t1 > t0, (ts_out - t0) / np.where(t1 > t0, t1 - t0, 1.0), 0.0)

    outer = np_slerp(quats[idx], quats[idx + 1], tau)
    inner_interp = np_slerp(inner[idx], inner[idx + 1], tau)
    return np_slerp(outer, inner_interp, 2.0 * tau * (1.0 - tau))


def resample_rotations(poses: np.ndarray, fps_in: float, fps_out: float) -> np.ndarray:
    """Resample an angle-axis motion track (F, J, 3) from ``fps_in`` to
    ``fps_out``: sign-continuous quaternions, SQUAD per joint."""
    quats = fix_quaternions(np_quat_from_aa(poses))  # (F, J, 4)
    n_frames = quats.shape[0]
    if n_frames < 2:
        raise ValueError("resampling needs at least two frames")
    duration = n_frames / fps_in
    ts_in = np.arange(0, duration, 1.0 / fps_in)[:n_frames]
    ts_out = np.arange(0, duration, 1.0 / fps_out)
    out = np.stack([squad(quats[:, j], ts_in, ts_out) for j in range(poses.shape[1])], axis=1)
    return np_quat_to_aa(out)
