"""Training-data synthesis on the device: root normalization, FK + virtual
sensors, mounting offsets; and the host transforms of the input pipeline,
the window draw and the normalization of real sensor data (port of
``empose_tpu/data/transforms.py``).

Every random draw (the subject of each sequence, the offset normals) comes
from an explicit ``torch.Generator`` on the batch's device. Each random
transform is split in two: a function that draws and a function that takes
the draws as arguments, so that a test can hand it the JAX package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from empose_tpu_torch.data.noise import make_noise_fn
from empose_tpu_torch.ops.quaternions import np_quat_from_aa
from empose_tpu_torch.ops.so3 import aa2rot, rot2aa
from empose_tpu_torch.parallel.mesh import batch_draw

NOISE_LEVELS = (-1, 0, 1, 2, 3)


@dataclass(frozen=True)
class OffsetBank:
    """Per-subject offset distributions: means (S, M, 3), Cholesky factors of
    the covariances chol (S, M, 3, 3), local->sensor rotations r (S, M, 3, 3)."""

    means: torch.Tensor
    chol: torch.Tensor
    r: torch.Tensor

    @property
    def n_subjects(self) -> int:
        return self.means.shape[0]

    @property
    def n_markers(self) -> int:
        return self.means.shape[1]

    @staticmethod
    def from_offset_files(offset_files: Sequence[str], device="cpu") -> "OffsetBank":
        """Stack ``*_offsets.npz`` files (means, covs, r) onto ``device``."""
        means, covs, rs = [], [], []
        for f in offset_files:
            data = np.load(f)
            means.append(np.asarray(data["means"], np.float32))
            covs.append(np.asarray(data["covs"], np.float32))
            rs.append(np.asarray(data["r"], np.float32))
        chol = np.linalg.cholesky(np.stack(covs) + 1e-12 * np.eye(3, dtype=np.float32))
        return OffsetBank(*(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                            for a in (np.stack(means), chol, np.stack(rs))))


def normalize_root(batch: Dict) -> Dict:
    """Zero the translation and left-multiply every root rotation by the
    inverse frame-0 root rotation; the originals go to ``trans_source`` and
    ``root_pose_source``."""
    poses = batch["poses"]
    root = poses[:, :, :3]
    root_ori_inv = aa2rot(root[:, 0]).transpose(-1, -2)[:, None]  # (N, 1, 3, 3)
    new_root = rot2aa(root_ori_inv @ aa2rot(root))
    out = dict(batch)
    out["trans_source"] = batch["trans"]
    out["root_pose_source"] = root
    out["poses"] = torch.cat([new_root, poses[:, :, 3:]], dim=-1)
    out["trans"] = torch.zeros_like(batch["trans"])
    return out


def smpl_fk_markers(sensor_smpl, batch: Dict) -> Dict:
    """FK over the whole batch: ground-truth joints and the raw virtual
    sensor frames (position, orientation, normal) with the batch's trans."""
    poses = batch["poses"]
    n, f = poses.shape[0], poses.shape[1]
    shapes = batch["shapes"].repeat_interleave(f, dim=0)
    m_pos, m_ori, m_nor, joints = sensor_smpl.markers_and_joints(
        poses.reshape(n * f, -1), shapes, trans=batch["trans"].reshape(n * f, 3))
    out = dict(batch)
    out["joints_gt"] = joints.reshape(n, f, -1)
    out["marker_pos_vertex"] = m_pos.reshape(n, f, -1)
    out["marker_ori_vertex"] = m_ori.reshape(n, f, -1)
    out["marker_nor_vertex"] = m_nor.reshape(n, f, -1)
    return out


def draw_offset_noise(bank: OffsetBank, n: int, f: int, generator: torch.Generator,
                      noise_level: int, randomize: bool):
    """The draws of :func:`sample_markers_with_offsets`: a subject index per
    sequence (N,), and standard normals (N, M, 3) at noise level 0, (N, F, M, 3)
    at level 1, else None; those of the global batch in a data-parallel step
    (``parallel/mesh.batch_draw``)."""
    dev = bank.means.device
    s_idx = batch_draw(lambda k: torch.randint(0, bank.n_subjects, (k,), generator=generator,
                                               device=dev), n)
    z = None
    if randomize and noise_level in (0, 1):
        rest = (bank.n_markers, 3) if noise_level == 0 else (f, bank.n_markers, 3)
        z = batch_draw(lambda k: torch.randn((k, *rest), generator=generator, device=dev), n)
    return s_idx, z


def sample_markers_with_offsets(batch: Dict, bank: OffsetBank, s_idx: torch.Tensor,
                                z: Optional[torch.Tensor], noise_level: int,
                                randomize: bool) -> Dict:
    """Apply per-subject mounting offsets to the raw virtual frames.

    Noise levels (not randomized: -1): -1 the subject's mean offsets; 0 one
    covariance sample per sequence; 1 one per frame; 2 zero translational
    offsets; 3 zero translations and identity rotation offsets. The offsets
    assumed known downstream are the subject means and rotations.
    """
    if noise_level not in NOISE_LEVELS:
        raise ValueError(f"Unknown noise level {noise_level}")
    n, f = batch["poses"].shape[0], batch["poses"].shape[1]
    m = bank.n_markers
    means = bank.means[s_idx]  # (N, M, 3)
    chol = bank.chol[s_idx]  # (N, M, 3, 3)
    local_offsets = means[:, None].expand(n, f, m, 3)
    if randomize:
        if noise_level == 0:
            samp = means + (chol @ z[..., None])[..., 0]
            local_offsets = samp[:, None].expand(n, f, m, 3)
        elif noise_level == 1:
            local_offsets = means[:, None] + (chol[:, None] @ z[..., None])[..., 0]
        elif noise_level in (2, 3):
            local_offsets = torch.zeros_like(local_offsets)

    ms = batch["marker_pos_vertex"].reshape(n, f, m, 3)
    ori = batch["marker_ori_vertex"].reshape(n, f, m, 3, 3)
    markers_new = ms + (ori @ local_offsets[..., None])[..., 0]
    r = bank.r[s_idx][:, None].expand(n, f, m, 3, 3)
    if randomize and noise_level == 3:
        r = torch.eye(3, dtype=ori.dtype, device=ori.device).expand(n, f, m, 3, 3)
    ori_new = ori @ r

    out = dict(batch)
    out["marker_pos"] = markers_new.reshape(n, f, -1)
    out["marker_ori"] = ori_new.reshape(n, f, -1)
    out["marker_nor"] = ori_new[..., 2].reshape(n, f, -1)
    out["offset_t"] = means
    out["offset_r"] = r[:, 0]
    return out


def make_preprocess_fn(sensor_smpl, bank: OffsetBank, config, randomize_if_configured: bool):
    """``preprocess(batch, generator, mode)`` with mode ``all`` (normalize,
    then synthesize), ``normalize_only`` or ``after_normalize`` (synthesize:
    FK, offsets, noise)."""
    noise_fn = make_noise_fn(config, randomize_if_configured)
    noise_level = config.offset_noise_level if randomize_if_configured else -1
    if not config.use_real_offsets:
        raise ValueError("We expect to use the real offsets.")

    def synth(batch, generator):
        n, f = batch["poses"].shape[0], batch["poses"].shape[1]
        batch = smpl_fk_markers(sensor_smpl, batch)
        s_idx, z = draw_offset_noise(bank, n, f, generator, noise_level, randomize_if_configured)
        batch = sample_markers_with_offsets(batch, bank, s_idx, z, noise_level,
                                            randomize_if_configured)
        return noise_fn(batch, generator)

    def preprocess(batch, generator, mode="all"):
        if mode == "all":
            return synth(normalize_root(batch), generator)
        if mode == "normalize_only":
            return normalize_root(batch)
        if mode == "after_normalize":
            return synth(batch, generator)
        raise ValueError(f"Mode '{mode}' unknown.")

    return preprocess


def extract_window(n_frames: int, window_size: int, rng: Optional[np.random.RandomState],
                   mode: str = "random"):
    """A (start, end) crop of ``window_size`` frames: the whole sequence when
    it is no longer, else at the start, the middle or a uniform random start."""
    if mode not in ("random", "beginning", "middle"):
        raise ValueError(f"Unknown window mode {mode!r}")
    if n_frames <= window_size:
        return 0, n_frames
    if mode == "beginning":
        return 0, window_size
    if mode == "middle":
        sf = n_frames // 2 - window_size // 2
        return sf, sf + window_size
    sf = rng.randint(0, n_frames - window_size + 1)
    return sf, sf + window_size


def normalize_real_markers(marker_pos: np.ndarray, marker_ori: np.ndarray,
                           smpl_poses: np.ndarray, smpl_trans: np.ndarray):
    """Real sensor data in the frame-0 root frame (host numpy, the JAX
    package's arithmetic, so the same bits): positions minus the per-frame root
    translation, then rotated by the inverse frame-0 root orientation;
    orientations left-multiplied by the same rotation.

    :param marker_pos: (F, M*3); :param marker_ori: (F, M*9);
    :param smpl_poses: (F, 66); :param smpl_trans: (F, 3).
    :return: (pos (F, M*3), ori (F, M*9)).
    """
    f = marker_pos.shape[0]
    m = marker_pos.shape[-1] // 3
    w, x, y, z = np_quat_from_aa(smpl_poses[0:1, :3])[0]
    r0 = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    pos = np.einsum("ab,fmb->fma", r0.T, marker_pos.reshape(f, m, 3) - smpl_trans[:, None, :])
    ori = np.einsum("ab,fmbc->fmac", r0.T, marker_ori.reshape(f, m, 3, 3))
    return pos.reshape(f, -1), ori.reshape(f, -1)
