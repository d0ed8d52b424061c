"""Metric engine: MPJPE, PA-MPJPE and MPJAE (port of
``empose_tpu/eval/metrics.py``).

Per frame and joint: the Euclidean error of the world joints, the same after
Procrustes alignment (rotation, scale and translation), and the geodesic
angle between the global joint orientations. The joints come from
``smplh_fk(want_vertices=False)`` over the 22-joint body subtree (root and
21 body joints; the hand joints are leaves below the wrists and move none of
them), the global orientations from ``local_to_global`` with a zero root.

Two ways to aggregate, with the reference's semantics (per-joint means over
all valid frames, then the mean over the evaluated joints; the std over the
raw frame x joint error matrix):

* the sufficient statistics ``metric_stats_*``: per joint the sum of errors,
  the sum of their squares and the count of valid frames, summed on the
  device in fp32 and merged on the host in float64;
* ``MetricsEngine``, the host oracle: per-frame error matrices copied to the
  host and aggregated there.

The batched Procrustes is Horn's quaternion method with a fixed-sweep cyclic
Jacobi eigen-solver. Its rotation sign is +1 where two diagonal entries are
equal (tau = 0); the JAX package's ``jnp.sign`` gives 0 there and skips the
rotation, which leaves exactly symmetric point sets unaligned.
``procrustes_align`` (SVD) is the oracle that the batched version is held
against.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import SMPLHModel, fold_zero_pose_joints, smplh_fk
from empose_tpu_torch.device import resolve_device
from empose_tpu_torch.ops.quaternions import rotation_intrinsic_distance_from_aa
from empose_tpu_torch.ops.so3 import local_to_global, so3_relative_angle

EUCL_EVAL_JOINTS = (
    "root", "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2", "l_ankle", "r_ankle",
    "spine3", "neck", "l_collar", "r_collar", "head", "l_shoulder", "r_shoulder",
    "l_elbow", "r_elbow", "l_wrist", "r_wrist",
)
ANGLE_EVAL_JOINTS = (
    "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2", "spine3",
    "neck", "l_collar", "r_collar", "head", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow",
)
EUCL_IDXS = tuple(C.SMPL_JOINTS.index(j) for j in EUCL_EVAL_JOINTS)
# The pose vector has no root: shift by -1.
ANGLE_IDXS = tuple(C.SMPL_JOINTS.index(j) - 1 for j in ANGLE_EVAL_JOINTS)

N_EUCL_JOINTS = C.N_JOINTS + 1   # root + 21 body joints
N_ANGLE_JOINTS = C.N_JOINTS      # body joints, root dropped
METRIC_NAMES = ("MPJPE [mm]", "MPJPE STD", "PA-MPJPE [mm]", "PA-MPJPE STD", "MPJAE [deg]",
                "MPJAE STD")
_JACOBI_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def body_model(smplh: SMPLHModel, device) -> SMPLHModel:
    """The 22-joint body subtree of ``smplh`` with tensors on ``device``:
    what the metrics' FK needs, without the mesh."""
    return fold_zero_pose_joints(smplh.subset([0]), N_EUCL_JOINTS).to(device)


def procrustes_align(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Align Y to X with the optimal rotation, scale and translation (the
    MATLAB procrustes with the optimal scale, reflections corrected), by
    SVD: the oracle. :param X, Y: (..., J, 3). :return: the aligned Y."""
    muX, muY = X.mean(-2, keepdim=True), Y.mean(-2, keepdim=True)
    X0, Y0 = X - muX, Y - muY
    normX = (X0 * X0).sum((-1, -2), keepdim=True).sqrt()
    normY = (Y0 * Y0).sum((-1, -2), keepdim=True).sqrt()
    # All points equal (padded frames): finite values, zeroed by the masks.
    X0 = X0 / torch.where(normX > 0, normX, torch.ones_like(normX))
    Y0 = Y0 / torch.where(normY > 0, normY, torch.ones_like(normY))
    U, s, Vt = torch.linalg.svd(X0.transpose(-1, -2) @ Y0, full_matrices=False)
    V = Vt.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    flip = torch.ones_like(s)
    flip[..., -1] = sign
    T = (V * flip[..., None, :]) @ U.transpose(-1, -2)
    trace = (s * flip).sum(-1)
    return normX * trace[..., None, None] * (Y0 @ T) + muX


def _horn_rotation(A: torch.Tensor):
    """(rows, 3, 3) -> (T (rows, 3, 3), lam (rows,)): the proper rotation T
    that maximizes tr(A T), from the top eigenvector of Horn's 4x4 matrix,
    and lam, that maximum (the reflection-corrected singular-value sum)."""
    S = [[A[..., i, j] for j in range(3)] for i in range(3)]
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = S
    K = torch.stack([
        torch.stack([xx + yy + zz, yz - zy, zx - xz, xy - yx], -1),
        torch.stack([yz - zy, xx - yy - zz, xy + yx, zx + xz], -1),
        torch.stack([zx - xz, xy + yx, -xx + yy - zz, yz + zy], -1),
        torch.stack([xy - yx, zx + xz, yz + zy, -xx - yy + zz], -1),
    ], -2)
    V = torch.eye(4, dtype=K.dtype, device=K.device).expand(K.shape).clone()
    one = torch.ones((), dtype=K.dtype, device=K.device)
    # 8 cyclic Jacobi sweeps: past fp32 precision for a 4x4.
    for _ in range(8):
        for p, q in _JACOBI_PAIRS:
            app, aqq, apq = K[..., p, p], K[..., q, q], K[..., p, q]
            tau = (aqq - app) / (2.0 * torch.where(apq.abs() > 0, apq, one))
            sign = torch.where(tau >= 0, one, -one)  # +1 at tau = 0: rotate by 45 degrees
            t = sign / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(apq.abs() > 1e-30, t, torch.zeros_like(t))
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = t[..., None] * c
            for M, rows in ((K, True), (K, False), (V, False)):
                a = M[..., p, :] if rows else M[..., :, p]
                b = M[..., q, :] if rows else M[..., :, q]
                a, b = c * a - s * b, s * a + c * b
                if rows:
                    M[..., p, :], M[..., q, :] = a, b
                else:
                    M[..., :, p], M[..., :, q] = a, b
    evals = torch.diagonal(K, dim1=-2, dim2=-1)
    idx = evals.argmax(-1)
    lam = evals.gather(-1, idx[..., None])[..., 0]
    q = V.gather(-1, idx[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]
    w, x, y, z = q.unbind(-1)
    T = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return T, lam


def procrustes_align_batched(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """:func:`procrustes_align` for (rows, J, 3) pairs, with the rotation and
    the corrected trace from :func:`_horn_rotation` instead of an SVD."""
    muX, muY = X.mean(-2, keepdim=True), Y.mean(-2, keepdim=True)
    X0, Y0 = X - muX, Y - muY
    normX = (X0 * X0).sum((-1, -2), keepdim=True).sqrt()
    normY = (Y0 * Y0).sum((-1, -2), keepdim=True).sqrt()
    X0 = X0 / torch.where(normX > 0, normX, torch.ones_like(normX))
    Y0 = Y0 / torch.where(normY > 0, normY, torch.ones_like(normY))
    T, lam = _horn_rotation(X0.transpose(-1, -2) @ Y0)
    return normX * lam[..., None, None] * (Y0 @ T) + muX


def _eucl_dists(kp_gt: torch.Tensor, kp_hat: torch.Tensor):
    """(B, J, 3) -> per-joint Euclidean errors (B, J), raw and after
    Procrustes alignment."""
    eucl = (kp_gt - kp_hat).square().sum(-1).sqrt()
    eucl_pa = (kp_gt - procrustes_align_batched(kp_gt, kp_hat)).square().sum(-1).sqrt()
    return eucl, eucl_pa


def _angle_dists(pose: torch.Tensor, pose_hat: torch.Tensor,
                 parents: Sequence[int] = C.SMPL_PARENTS) -> torch.Tensor:
    """Geodesic error (degrees) of the global orientations of body poses
    (B, J*3) without the root, a zero root prepended: (B, J)."""
    b = pose.shape[0]
    zero = pose.new_zeros(b, 3)
    glob = local_to_global(torch.cat([zero, pose], -1), parents).reshape(b, -1, 3)[:, 1:]
    glob_hat = local_to_global(torch.cat([zero, pose_hat], -1), parents).reshape(b, -1, 3)[:, 1:]
    return torch.rad2deg(rotation_intrinsic_distance_from_aa(glob, glob_hat))


def _raw_aa_angles(pose: torch.Tensor, pose_hat: torch.Tensor) -> torch.Tensor:
    """Per-joint geodesic angles (degrees) of raw angle-axis (B, J*3), no
    kinematic chain."""
    b = pose.shape[0]
    return torch.rad2deg(rotation_intrinsic_distance_from_aa(pose.reshape(b, -1, 3),
                                                             pose_hat.reshape(b, -1, 3)))


def _rotmat_angles(pose: torch.Tensor, pose_hat: torch.Tensor) -> torch.Tensor:
    """Per-joint geodesic angles (degrees) of flattened rotation matrices (B, J*9)."""
    b = pose.shape[0]
    return torch.rad2deg(so3_relative_angle(pose.reshape(b, -1, 3, 3),
                                            pose_hat.reshape(b, -1, 3, 3)))


def _frame_errors(body: SMPLHModel, p, s, r, p_hat, s_hat, r_hat):
    """FK of both sides and the three per-frame error matrices of flat rows:
    (eucl (R, 22), eucl_pa (R, 22), angles (R, 21))."""
    _, kp = smplh_fk(body, p, s, r, want_vertices=False)
    _, kp_hat = smplh_fk(body, p_hat, s_hat, r_hat, want_vertices=False)
    eucl, eucl_pa = _eucl_dists(kp, kp_hat)
    return eucl, eucl_pa, _angle_dists(p, p_hat)


# ---------------------------------------------------------------------------
# Sufficient statistics. Per joint the error sum, the sum of squares and the
# valid-frame count are all the aggregation needs:
#   mean = mean over joints of (sum_j / n),
#   std  = sqrt(E[e^2] - E[e]^2) over the (n x joints) error matrix.
# ---------------------------------------------------------------------------

def metric_stats_init(n_seqs: Optional[int] = None, device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed fp32 statistics on ``device``: scalar ``n`` and (J,) sums for a
    pass aggregate (``n_seqs`` None), or a leading sequence axis for
    per-sequence statistics (the batched pass)."""
    lead = () if n_seqs is None else (n_seqs,)
    z = lambda *s: torch.zeros(lead + s, dtype=torch.float32, device=device)  # noqa: E731
    return {"n": z(),
            "eucl_sum": z(N_EUCL_JOINTS), "eucl_sq": z(N_EUCL_JOINTS),
            "pa_sum": z(N_EUCL_JOINTS), "pa_sq": z(N_EUCL_JOINTS),
            "ang_sum": z(N_ANGLE_JOINTS), "ang_sq": z(N_ANGLE_JOINTS)}


def valid_mask(n: int, f: int, seq_lengths, frame_mask, device="cpu") -> torch.Tensor:
    """(N, F) bool: frame index below the sequence length and, for a 3-D
    (N, F, M) ``frame_mask``, no marker of the frame masked (0)."""
    if seq_lengths is None:
        mask = torch.ones(n, f, dtype=torch.bool, device=device)
    else:
        mask = torch.arange(f, device=device)[None, :] < seq_lengths[:, None]
    if frame_mask is not None:
        fm = frame_mask
        if fm.ndim == 3:
            fm = ~(fm == 0).any(-1)
        mask = mask & fm.bool()
    return mask


def metric_stats_update(body: SMPLHModel, stats: Dict[str, torch.Tensor], pose, shape, pose_hat,
                        shape_hat=None, seq_lengths=None, pose_root=None, pose_root_hat=None,
                        frame_mask=None, per_sample: bool = False) -> Dict[str, torch.Tensor]:
    """Add one (N, F) window's masked error sums to ``stats`` (tensors on
    the body model's device, no host sync).

    :param body: :func:`body_model`; :param pose: (N, F, 63) body pose
      without the root; :param shape: (N, B) ground-truth betas.
    :param shape_hat: (N, B) predicted betas, (N, F, B) per frame, or None
      (the ground truth's).
    :param per_sample: sum over frames only, keeping the sequence axis;
      ``stats`` from ``metric_stats_init(N)``.
    """
    n, f = pose.shape[0], pose.shape[1]
    rows = n * f
    dev = pose.device
    shape_hat = shape if shape_hat is None else shape_hat
    mask2 = valid_mask(n, f, seq_lengths, frame_mask, dev)
    mask = mask2.reshape(rows, 1)

    def flat_shape(s):
        if s.ndim == 3:
            return s.reshape(rows, -1)
        return s[:, None].expand(n, f, s.shape[-1]).reshape(rows, -1)

    p, p_hat = pose.reshape(rows, -1), pose_hat.reshape(rows, -1)
    if pose_root is None:
        r = r_hat = p.new_zeros(rows, 3)
    else:
        r, r_hat = pose_root.reshape(rows, 3), pose_root_hat.reshape(rows, 3)
    eucl, eucl_pa, angles = _frame_errors(body, p, flat_shape(shape), r, p_hat,
                                          flat_shape(shape_hat), r_hat)

    if per_sample:
        def acc(x):
            return torch.where(mask, x, 0.0).reshape(n, f, -1).sum(1)
        count = mask2.float().sum(1)
    else:
        def acc(x):
            return torch.where(mask, x, 0.0).sum(0)
        count = mask2.float().sum()
    return {"n": stats["n"] + count,
            "eucl_sum": stats["eucl_sum"] + acc(eucl), "eucl_sq": stats["eucl_sq"] + acc(eucl * eucl),
            "pa_sum": stats["pa_sum"] + acc(eucl_pa), "pa_sq": stats["pa_sq"] + acc(eucl_pa * eucl_pa),
            "ang_sum": stats["ang_sum"] + acc(angles), "ang_sq": stats["ang_sq"] + acc(angles * angles)}


def stats_to_host(stats: Dict) -> Dict[str, np.ndarray]:
    """Statistics as host numpy (one copy per entry)."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in stats.items()}


def metric_stats_merge(a: Dict, b: Dict) -> Dict[str, np.ndarray]:
    """Host float64 sum of two statistics (the overall row = the sum over
    sequences)."""
    a, b = stats_to_host(a), stats_to_host(b)
    return {k: a[k].astype(np.float64) + b[k].astype(np.float64) for k in a}


def metric_stats_select(stats: Dict, i: int) -> Dict[str, np.ndarray]:
    """Row ``i`` of per-sequence statistics, as pass-aggregate statistics."""
    return {k: v[i] for k, v in stats_to_host(stats).items()}


def metric_stats_reduce(stats: Dict) -> Dict[str, np.ndarray]:
    """Per-sequence statistics summed over sequences in float64."""
    return {k: v.astype(np.float64).sum(0) for k, v in stats_to_host(stats).items()}


def metrics_from_stats(stats: Dict) -> Dict[str, float]:
    """The metric dict of :meth:`MetricsEngine.get_metrics` from statistics,
    in float64. No valid frame gives zeros."""
    st = {k: v.astype(np.float64) for k, v in stats_to_host(stats).items()}
    n = float(st["n"])
    if n == 0:
        return dict.fromkeys(METRIC_NAMES, 0.0)

    def agg(sum_j, sq_j, idxs):
        mean = float(np.mean(sum_j[idxs] / n))
        k = n * len(idxs)
        m1, m2 = sum_j[idxs].sum() / k, sq_j[idxs].sum() / k
        return mean, float(np.sqrt(max(m2 - m1 * m1, 0.0)))

    e_mean, e_std = agg(st["eucl_sum"], st["eucl_sq"], list(EUCL_IDXS))
    pa_mean, pa_std = agg(st["pa_sum"], st["pa_sq"], list(EUCL_IDXS))
    a_mean, a_std = agg(st["ang_sum"], st["ang_sq"], list(ANGLE_IDXS))
    return dict(zip(METRIC_NAMES, (e_mean * 1000.0, e_std * 1000.0, pa_mean * 1000.0,
                                   pa_std * 1000.0, a_mean, a_std)))


def format_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """A plain-text table: a header line, a rule of dashes, one line per
    row; numbers right-aligned with 6 significant digits, text left-aligned."""
    def cell(v):
        return f"{v:g}" if isinstance(v, (float, np.floating)) else str(v)

    def numeric(v):
        return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)

    cells = [[cell(v) for v in r] for r in rows]
    widths = [max([len(h)] + [len(r[i]) for r in cells]) for i, h in enumerate(headers)]
    right = [bool(rows) and all(numeric(r[i]) for r in rows) for i in range(len(headers))]

    def line(vals):
        return "  ".join(v.rjust(w) if rt else v.ljust(w)
                         for v, w, rt in zip(vals, widths, right)).rstrip()

    return "\n".join([line(list(headers)), "  ".join("-" * w for w in widths)]
                     + [line(r) for r in cells])


class MetricsEngine:
    """The host oracle: per-frame error matrices computed on ``device``
    (None = CUDA), copied to the host batch by batch, aggregated at the end.

    :param smplh: the SMPL-H model (only its body joints are used).
    """

    def __init__(self, smplh: SMPLHModel, device=None):
        self.device = resolve_device(device)
        self.body = body_model(smplh, self.device)
        self.reset()

    def reset(self) -> None:
        self.eucl_dists: List[np.ndarray] = []
        self.eucl_dists_pa: List[np.ndarray] = []
        self.angle_diffs: List[np.ndarray] = []
        self._stats_override = None

    def set_stats(self, host_stats: Dict) -> None:
        """Aggregate from these statistics instead (the trainer's stats
        passes); cleared by :meth:`reset`."""
        self._stats_override = host_stats

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)

    @staticmethod
    def _valid_mask(n, f, seq_lengths, frame_mask) -> np.ndarray:
        lengths = np.full(n, f) if seq_lengths is None else np.asarray(seq_lengths)
        mask = np.arange(f)[None, :] < lengths[:, None]
        if frame_mask is not None:
            fm = np.asarray(frame_mask)
            if fm.ndim == 3:
                fm = ~np.any(fm == 0, axis=-1)
            mask = mask & fm.astype(bool)
        return mask

    def compute(self, pose, shape, pose_hat, shape_hat=None, seq_lengths=None,
                pose_root=None, pose_root_hat=None, frame_mask=None) -> None:
        """Errors of the valid frames of one (N, F) batch. :param pose:
        (N, F, 63) body pose without the root; :param shape: (N, B);
        :param shape_hat: (N, B), (N, F, B) or None (the ground truth's)."""
        pose = np.asarray(pose)
        n, f = pose.shape[0], pose.shape[1]
        shape_hat = shape if shape_hat is None else shape_hat
        mask = self._valid_mask(n, f, seq_lengths, frame_mask)
        if mask.sum() == 0:
            return

        def rows(x):
            return self._tensor(np.asarray(x)[mask])

        def shape_rows(s):
            s = np.asarray(s)
            if s.ndim == 3:
                return self._tensor(s[mask])
            return self._tensor(np.broadcast_to(s[:, None], (n, f, s.shape[-1]))[mask])

        p, p_hat = rows(pose), rows(pose_hat)
        if pose_root is None:
            r = r_hat = p.new_zeros(p.shape[0], 3)
        else:
            r, r_hat = rows(pose_root), rows(pose_root_hat)
        with torch.no_grad():
            eucl, eucl_pa, angles = _frame_errors(self.body, p, shape_rows(shape), r, p_hat,
                                                  shape_rows(shape_hat), r_hat)
        self.eucl_dists.append(eucl.cpu().numpy())
        self.eucl_dists_pa.append(eucl_pa.cpu().numpy())
        self.angle_diffs.append(angles.cpu().numpy())

    def compute_joint_dist(self, joints, joints_hat, seq_lengths=None, frame_mask=None) -> None:
        """Positional errors of precomputed joints (N, F, J*3)."""
        joints = np.asarray(joints)
        n, f = joints.shape[0], joints.shape[1]
        mask = self._valid_mask(n, f, seq_lengths, frame_mask)
        if mask.sum() == 0:
            return
        kp = joints[mask].reshape(-1, joints.shape[-1] // 3, 3)[:, :N_EUCL_JOINTS]
        kp_hat = np.asarray(joints_hat)[mask].reshape(kp.shape[0], -1, 3)[:, :N_EUCL_JOINTS]
        with torch.no_grad():
            eucl, eucl_pa = _eucl_dists(self._tensor(kp), self._tensor(kp_hat))
        self.eucl_dists.append(eucl.cpu().numpy())
        self.eucl_dists_pa.append(eucl_pa.cpu().numpy())

    def compute_angle_dist(self, pose, pose_hat, seq_lengths=None, frame_mask=None,
                           rep: str = "aa") -> None:
        """Angular errors only: ``rep`` 'aa' (raw angle-axis per joint) or
        'rotmat' (flattened rotation matrices)."""
        if rep not in ("aa", "rotmat"):
            raise ValueError(f"rep must be 'aa' or 'rotmat', got {rep!r}")
        pose = np.asarray(pose)
        n, f = pose.shape[0], pose.shape[1]
        mask = self._valid_mask(n, f, seq_lengths, frame_mask)
        if mask.sum() == 0:
            return
        p, p_hat = self._tensor(pose[mask]), self._tensor(np.asarray(pose_hat)[mask])
        with torch.no_grad():
            angles = (_rotmat_angles if rep == "rotmat" else _raw_aa_angles)(p, p_hat)
        self.angle_diffs.append(angles.cpu().numpy())

    def get_metrics(self, eucl_idxs_select: bool = True,
                    angle_idxs_select: bool = True) -> Dict[str, float]:
        """Per-joint means over all frames, then the mean over the evaluated
        joints (all joints where ``*_select`` is False); stds over the raw
        error matrices."""
        if self._stats_override is not None:
            if not (eucl_idxs_select and angle_idxs_select):
                raise ValueError("metrics from statistics exist only for the evaluated joints")
            return metrics_from_stats(self._stats_override)
        eucl_mean = eucl_std = pa_mean = pa_std = ang_mean = ang_std = 0.0
        if self.eucl_dists:
            eucl = np.concatenate(self.eucl_dists, 0)
            eucl_pa = np.concatenate(self.eucl_dists_pa, 0)
            idxs = list(EUCL_IDXS) if eucl_idxs_select else list(range(eucl.shape[1]))
            eucl_mean = float(np.mean(np.mean(eucl, 0)[idxs]))
            eucl_std = float(np.std(eucl[:, idxs]))
            pa_mean = float(np.mean(np.mean(eucl_pa, 0)[idxs]))
            pa_std = float(np.std(eucl_pa[:, idxs]))
        if self.angle_diffs:
            ang = np.concatenate(self.angle_diffs, 0)
            idxs = list(ANGLE_IDXS) if angle_idxs_select else list(range(ang.shape[1]))
            ang_mean = float(np.mean(np.mean(ang, 0)[idxs]))
            ang_std = float(np.std(ang[:, idxs]))
        return dict(zip(METRIC_NAMES, (eucl_mean * 1000.0, eucl_std * 1000.0, pa_mean * 1000.0,
                                       pa_std * 1000.0, ang_mean, ang_std)))

    @staticmethod
    def to_pretty_string(metrics: Dict[str, float], model_name) -> str:
        headers = list(metrics)
        return format_table(["Model"] + headers, [[model_name] + [metrics[k] for k in headers]])

    @staticmethod
    def to_log_dict(metrics: Dict[str, float], prefix: str = "") -> Dict[str, float]:
        return {f"metrics/{prefix}/mje mean": metrics["MPJPE [mm]"],
                f"metrics/{prefix}/mje pa mean": metrics["PA-MPJPE [mm]"],
                f"metrics/{prefix}/mae mean": metrics["MPJAE [deg]"]}
