"""Samples and batch collation into dicts of padded numpy arrays (port of
``empose_tpu/data/batches.py``).

Batch keys: ``ids`` (list), ``poses`` (N, F, 66) root and body angle-axis,
``shapes`` (N, 10), ``trans`` (N, F, 3), ``seq_lengths`` (N,) int32, and
for real recordings ``marker_pos`` (N, F, M*3), ``marker_ori`` (N, F, M*9),
``marker_nor`` (N, F, M*3), ``marker_masks`` (N, F, M) (1 = available),
``offset_t`` (N, M, 3) and ``offset_r`` (N, M, 3, 3); for mocap sequences
``joints_gt`` (N, F, 66). F is the longest sequence rounded up to
``pad_multiple``. The same samples give the JAX package's batches byte for
byte.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.data.transforms import normalize_real_markers

TIME_KEYS = ("poses", "trans", "joints_gt", "marker_pos", "marker_ori", "marker_nor",
             "marker_masks")


def to_device(batch: Dict, device) -> Dict[str, "torch.Tensor"]:
    """A host batch as tensors on ``device``: ``seq_lengths`` int64, every
    other array fp32, ``ids`` dropped."""
    return {k: torch.as_tensor(np.asarray(v)).to(
                device, torch.int64 if k == "seq_lengths" else torch.float32)
            for k, v in batch.items() if k != "ids"}


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class RealSample:
    """One real EM recording with its ground-truth SMPL parameters and the
    subject's mounting offsets."""

    def __init__(self, seq_id, marker_pos, marker_ori, marker_masks, smpl_poses,
                 smpl_shape, smpl_trans, offset_data):
        if marker_pos.shape[0] != smpl_poses.shape[0]:
            raise ValueError(f"{seq_id}: {marker_pos.shape[0]} sensor frames but "
                             f"{smpl_poses.shape[0]} pose frames")
        self.id = seq_id
        f = marker_pos.shape[0]
        self.marker_pos = np.asarray(marker_pos, np.float32).reshape(f, -1)
        self.marker_ori = np.asarray(marker_ori, np.float32).reshape(f, -1)
        self.marker_masks = np.asarray(marker_masks, np.float32)
        self.smpl_poses = np.asarray(smpl_poses, np.float32)
        self.smpl_shape = np.asarray(smpl_shape, np.float32)
        self.smpl_trans = np.asarray(smpl_trans, np.float32)
        self.offset_means = np.asarray(offset_data["means"], np.float32)
        self.offset_covs = np.asarray(offset_data["covs"], np.float32)
        self.offset_r = np.asarray(offset_data["r"], np.float32)

    @classmethod
    def from_npz_clean(cls, npz_file: str) -> "RealSample":
        """Read a ``*_clean.npz`` recording (keys id, sensor_pos, sensor_oris,
        sensor_masks, smpl_poses, smpl_shape, smpl_trans, offset_means,
        offset_covs, offset_r)."""
        if not npz_file.endswith("_clean.npz"):
            raise ValueError(f"not a *_clean.npz recording: {npz_file}")
        data = np.load(npz_file)
        offset_data = {"means": data["offset_means"], "covs": data["offset_covs"],
                       "r": data["offset_r"]}
        return cls(str(data["id"]), data["sensor_pos"], data["sensor_oris"], data["sensor_masks"],
                   data["smpl_poses"], data["smpl_shape"], data["smpl_trans"], offset_data)

    @property
    def n_frames(self) -> int:
        return self.marker_pos.shape[0]

    @property
    def n_markers(self) -> int:
        return self.marker_pos.shape[-1] // 3

    def normalize_markers(self) -> "RealSample":
        """Sensor data into the frame-0 root frame (:func:`normalize_real_markers`)."""
        pos, ori = normalize_real_markers(self.marker_pos, self.marker_ori,
                                          self.smpl_poses, self.smpl_trans)
        self.marker_pos = pos.astype(np.float32)
        self.marker_ori = ori.astype(np.float32)
        return self

    def extract_window(self, sf: int, ef: int) -> "RealSample":
        return RealSample(self.id, self.marker_pos[sf:ef], self.marker_ori[sf:ef],
                          self.marker_masks[sf:ef], self.smpl_poses[sf:ef], self.smpl_shape,
                          self.smpl_trans[sf:ef],
                          {"means": self.offset_means, "covs": self.offset_covs, "r": self.offset_r})


class AMASSSample:
    """One mocap sequence: root and body pose, betas, translation, optional joints."""

    def __init__(self, seq_id, poses, shape, trans, fps=C.FPS, joints=None, gender="unknown"):
        if poses.shape[1] < C.MAX_INDEX_ROOT_AND_BODY:
            raise ValueError(f"{seq_id}: poses have {poses.shape[1]} dofs, fewer than "
                             f"{C.MAX_INDEX_ROOT_AND_BODY}")
        self.id = seq_id
        self.poses = np.asarray(poses, np.float32)[:, : C.MAX_INDEX_ROOT_AND_BODY]
        self.shape = np.asarray(shape, np.float32)[: C.N_SHAPE_PARAMS]
        self.trans = np.asarray(trans, np.float32)
        self.joints = None if joints is None else \
            np.asarray(joints, np.float32)[:, : (C.N_JOINTS + 1) * 3]
        self.fps = fps
        self.gender = gender

    @property
    def n_frames(self) -> int:
        return self.poses.shape[0]

    def extract_window(self, sf: int, ef: int) -> "AMASSSample":
        return AMASSSample(self.id, self.poses[sf:ef], self.shape, self.trans[sf:ef], self.fps,
                           None if self.joints is None else self.joints[sf:ef], self.gender)


def collate_amass(samples: List[AMASSSample], pad_multiple: int = 32) -> Dict[str, np.ndarray]:
    """Pad and stack mocap samples (``joints_gt`` zero where a sample has none)."""
    n = len(samples)
    lengths = np.asarray([s.n_frames for s in samples], np.int32)
    f = _round_up(int(lengths.max()), pad_multiple)
    poses = np.zeros((n, f, C.MAX_INDEX_ROOT_AND_BODY), np.float32)
    trans = np.zeros((n, f, 3), np.float32)
    shapes = np.zeros((n, C.N_SHAPE_PARAMS), np.float32)
    joints = np.zeros((n, f, (C.N_JOINTS + 1) * 3), np.float32)
    for i, s in enumerate(samples):
        poses[i, : s.n_frames] = s.poses
        trans[i, : s.n_frames] = s.trans
        shapes[i, : s.shape.shape[0]] = s.shape
        if s.joints is not None:
            joints[i, : s.n_frames] = s.joints
    return {"ids": [s.id for s in samples], "poses": poses, "shapes": shapes, "trans": trans,
            "joints_gt": joints, "seq_lengths": lengths}


def collate_real(samples: List[RealSample], pad_multiple: int = 32,
                 mask_value: float = 0.0) -> Dict[str, np.ndarray]:
    """Pad and stack real samples. Sensor channels that the masks mark
    missing take ``mask_value``, as suppression noise in training does."""
    n = len(samples)
    m = samples[0].n_markers
    lengths = np.asarray([s.n_frames for s in samples], np.int32)
    f = _round_up(int(lengths.max()), pad_multiple)
    out = {
        "ids": [s.id for s in samples],
        "poses": np.zeros((n, f, C.MAX_INDEX_ROOT_AND_BODY), np.float32),
        "shapes": np.zeros((n, C.N_SHAPE_PARAMS), np.float32),
        "trans": np.zeros((n, f, 3), np.float32),
        "seq_lengths": lengths,
        "marker_pos": np.zeros((n, f, m * 3), np.float32),
        "marker_ori": np.zeros((n, f, m * 9), np.float32),
        "marker_nor": np.zeros((n, f, m * 3), np.float32),
        "marker_masks": np.zeros((n, f, m), np.float32),
        "offset_t": np.zeros((n, m, 3), np.float32),
        "offset_r": np.zeros((n, m, 3, 3), np.float32),
    }
    for i, s in enumerate(samples):
        L = s.n_frames
        out["poses"][i, :L] = s.smpl_poses[:, : C.MAX_INDEX_ROOT_AND_BODY]
        out["shapes"][i] = s.smpl_shape[: C.N_SHAPE_PARAMS]
        out["trans"][i, :L] = s.smpl_trans
        valid = (s.marker_masks == 1.0)[..., None]  # (L, M, 1)
        pos = s.marker_pos.reshape(L, m, 3)
        ori = s.marker_ori.reshape(L, m, 3, 3)
        out["marker_pos"][i, :L] = np.where(valid, pos, mask_value).reshape(L, -1)
        out["marker_ori"][i, :L] = np.where(valid[..., None], ori, mask_value).reshape(L, -1)
        out["marker_nor"][i, :L] = np.where(valid, ori[..., 2], mask_value).reshape(L, -1)
        out["marker_masks"][i, :L] = s.marker_masks
        out["offset_t"][i] = s.offset_means
        out["offset_r"][i] = s.offset_r
    return out


def slice_window(batch: Dict, sf: int, ef: int) -> Dict:
    """Frames [sf, ef) of a collated batch; ``seq_lengths`` become each
    sample's true frames inside the window (clipped, not the window span)."""
    out = {k: (v[:, sf:ef] if k in TIME_KEYS and v is not None else v) for k, v in batch.items()}
    lengths = np.clip(np.asarray(batch["seq_lengths"]) - sf, 0, ef - sf)
    out["seq_lengths"] = lengths.astype(np.int32)
    return out
