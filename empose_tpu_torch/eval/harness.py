"""Evaluation harness of the port; for now the visualization export only.

Port of ``empose_tpu/eval/harness.py::export_visualization``: GT and
predicted joints and full-mesh vertices of one sequence as an npz, and OBJ
meshes of frame 0. The full-mesh FK runs in chunks of 512 frames through
``SMPLLayer.fk``, so the skinning goes through the LBS kernel on the card.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import SMPLLayer

VIS_CHUNK = 512  # frames per full-mesh FK call


def _write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {a} {b} {c}\n")


def export_visualization(smpl, seq_id: str, host_batch: Dict, pose_full_hat: np.ndarray,
                         shape_hat: Optional[np.ndarray], out_dir: str, device=None) -> str:
    """Dump predicted-vs-GT skeleton and mesh artifacts for one sequence.

    :param smpl: an ``SMPLLayer``, or an object whose ``full`` is a full-mesh
      ``SMPLHModel`` (then a layer is built on ``device``).
    :param host_batch: numpy batch of one sequence (``seq_lengths``,
      ``poses`` (1, F, 66), ``shapes`` (1, 10)).
    :param pose_full_hat: (F, 66) predicted root+body pose (angle-axis).
    :param shape_hat: (10,) predicted betas or None (GT betas reused).
    :return: path of the written npz (beside it ``<seq_id>_frame0_gt.obj``
      and ``<seq_id>_frame0_pred.obj``).
    """
    layer = smpl if isinstance(smpl, SMPLLayer) else SMPLLayer(smpl.full, device)
    os.makedirs(out_dir, exist_ok=True)
    true_len = int(np.asarray(host_batch["seq_lengths"])[0])
    poses_gt = np.asarray(host_batch["poses"])[0, :true_len]
    shape_gt = np.asarray(host_batch["shapes"])[0]
    pose_hat = np.asarray(pose_full_hat)[:true_len]
    betas_hat = shape_gt if shape_hat is None else np.asarray(shape_hat).reshape(-1)

    def fk(poses, betas):
        vs, js = [], []
        with torch.no_grad():
            for s in range(0, poses.shape[0], VIS_CHUNK):
                p = np.asarray(poses[s:s + VIS_CHUNK], np.float32)
                v, j = layer.fk(p[:, 3:], np.asarray(betas, np.float32)[None], poses_root=p[:, :3])
                vs.append(v.cpu().numpy())
                js.append(j[:, : C.N_JOINTS + 1].cpu().numpy())
        return np.concatenate(vs), np.concatenate(js)

    verts_gt, joints_gt = fk(poses_gt, shape_gt)
    verts_hat, joints_hat = fk(pose_hat, betas_hat)
    faces = np.asarray(layer.faces)

    npz_path = os.path.join(out_dir, f"{seq_id}.npz")
    np.savez_compressed(
        npz_path, joints_gt=joints_gt, joints_hat=joints_hat,
        verts_gt=verts_gt, verts_hat=verts_hat, faces=faces,
        poses_gt=poses_gt, pose_hat=pose_hat, shape_gt=shape_gt, shape_hat=betas_hat,
        parents=np.asarray(C.SMPL_PARENTS[: C.N_JOINTS + 1]))
    _write_obj(os.path.join(out_dir, f"{seq_id}_frame0_gt.obj"), verts_gt[0], faces)
    _write_obj(os.path.join(out_dir, f"{seq_id}_frame0_pred.obj"), verts_hat[0], faces)
    print(f"Visualization artifacts written to {out_dir}")
    return npz_path
