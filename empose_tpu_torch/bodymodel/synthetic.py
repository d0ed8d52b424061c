"""Synthetic SMPL-H-shaped body model for development, tests and the card.

The port's own copy of ``empose_tpu/bodymodel/synthetic.py::make_synthetic_smplh``:
the licensed SMPL-H cannot be redistributed, so this fabricates a model with
the same npz keys, shapes, 52-joint kinematic tree and mesh resolution
(6890 vertices, 13416 faces). The same seed gives the same arrays as the JAX
package's generator.
"""

from __future__ import annotations

import numpy as np

from empose_tpu_torch import constants as C
from empose_tpu_torch.ops.quaternions import np_quat_from_aa

N_VERTICES = 6890
GRID_ROWS = 130
GRID_COLS = 53  # 130 * 53 = 6890

# SMPL-H kinematic tree: 22 body joints + 15 left + 15 right hand joints.
SMPLH_PARENTS = tuple(
    list(C.SMPL_PARENTS)
    + [20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35]
    + [21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50]
)


def cylinder_mesh():
    """A (6890, 3) vertex grid rolled into a cylinder and its triangulation."""
    rows, cols = GRID_ROWS, GRID_COLS
    theta = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    z = np.linspace(0.0, 1.7, rows)
    tt, zz = np.meshgrid(theta, z)
    r = 0.25 + 0.05 * np.sin(3 * tt) * np.cos(2 * np.pi * zz / 1.7)
    verts = np.stack([r * np.cos(tt), r * np.sin(tt), zz], axis=-1).reshape(-1, 3)

    faces = []
    for i in range(rows - 1):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            c = (i + 1) * cols + j
            d = (i + 1) * cols + (j + 1) % cols
            faces.append([a, b, c])
            faces.append([b, d, c])
    return verts.astype(np.float64), np.asarray(faces, dtype=np.int64)


def make_synthetic_smplh(seed: int = 0, num_betas: int = 16) -> dict:
    """Fabricate an SMPL-H npz dict (same keys/shapes as the AMASS release)."""
    rng = np.random.RandomState(seed)
    n_joints = len(SMPLH_PARENTS)
    v_template, faces = cylinder_mesh()

    shapedirs = rng.randn(N_VERTICES, 3, num_betas) * 0.01
    posedirs = rng.randn(N_VERTICES, 3, (n_joints - 1) * 9) * 0.001

    # Joint regressor: each joint averages a local blob of vertices.
    j_regressor = np.zeros((n_joints, N_VERTICES))
    anchor_rows = np.linspace(3, GRID_ROWS - 4, n_joints).astype(int)
    for j in range(n_joints):
        vs = anchor_rows[j] * GRID_COLS + (rng.permutation(GRID_COLS)[:8])
        j_regressor[j, vs] = 1.0 / len(vs)

    # LBS weights: soft assignment to the nearest joints along the grid rows.
    rows_of_vertex = np.arange(N_VERTICES) // GRID_COLS
    d = np.abs(rows_of_vertex[:, None] - anchor_rows[None, :]).astype(np.float64)
    w = np.exp(-0.5 * (d / 6.0) ** 2) + 1e-6
    weights = w / w.sum(axis=1, keepdims=True)

    kintree = np.zeros((2, n_joints), dtype=np.uint32)
    kintree[0] = np.asarray([p if p >= 0 else np.iinfo(np.uint32).max for p in SMPLH_PARENTS], dtype=np.uint32)
    kintree[1] = np.arange(n_joints, dtype=np.uint32)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": j_regressor,
        "weights": weights,
        "kintree_table": kintree,
        "f": faces.astype(np.int32),
    }


def smooth_random_poses(rng: np.random.RandomState, n_frames: int, n_dofs: int = 66,
                        scale: float = 0.4) -> np.ndarray:
    """Temporally smooth random tracks (n_frames, n_dofs): linear
    interpolation between max(4, n_frames // 20) random control frames."""
    n_ctrl = max(4, n_frames // 20)
    ctrl = rng.randn(n_ctrl, n_dofs) * scale
    t_ctrl = np.linspace(0, 1, n_ctrl)
    t = np.linspace(0, 1, n_frames)
    return np.stack([np.interp(t, t_ctrl, ctrl[:, d]) for d in range(n_dofs)], axis=1)


def make_offset_data(rng: np.random.RandomState, n_markers: int = 12) -> dict:
    """Per-subject sensor mounting offsets (means/covs/r), reference format."""
    means = rng.randn(n_markers, 3) * 0.02
    a = rng.randn(n_markers, 3, 3) * 0.005
    covs = np.einsum("mab,mcb->mac", a, a) + np.eye(3) * 1e-6
    # Small random rotations for the local->sensor frame offset.
    aa = rng.randn(n_markers, 3) * 0.1
    q = np_quat_from_aa(aa)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(n_markers, 3, 3)
    return {
        "means": means,
        "covs": covs,
        "r": r,
        "vertex_ids": np.asarray(C.VERTEX_IDS, dtype=np.int64),
    }
