"""Plain SMPL-H forward kinematics and virtual EM sensors, float32.

Written from the model's description (SMPL-H: shape and pose blend shapes,
joint regression, a kinematic chain of rigid transforms, linear blend
skinning) and the virtual-sensor definition of EM-POSE (a sensor sits on a
mesh vertex; its frame is [tangent to a neighbouring vertex, normal x
tangent, unit vertex normal], the vertex normal being the mean of the
incident face normals). Only the vertices the sensors read are skinned, and
the 30 hand joints, always at zero pose here, are folded into the wrists.

The chain is composed joint by joint in tree order, not level by level, so
its sums run in another order than the program's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# The 12 sensor vertices of the SMPL-H mesh, in the network's input order,
# and the 6-sensor subset (EM-POSE's configuration).
VERTEX_IDS = (3027, 3748, 5430, 5178, 5006, 4447, 4559, 1961, 1391, 1535, 959, 1072)
SENSORS_6 = (0, 1, 2, 6, 7, 11)
BODY_JOINTS = 21          # not counting the root
N_BETAS = 10


def vertex_faces(n_vertices: int, faces: np.ndarray) -> np.ndarray:
    """Per vertex, its incident faces in ascending face order, -1 padded."""
    lists = [[] for _ in range(n_vertices)]
    for fi, face in enumerate(np.asarray(faces, np.int64)):
        for v in face:
            lists[int(v)].append(fi)
    deg = max(len(x) for x in lists)
    out = -np.ones((n_vertices, deg), np.int64)
    for v, x in enumerate(lists):
        out[v, :len(x)] = x
    return out


@dataclass
class SensorBody:
    """The skinned vertex subset and the sensor topology, as tensors."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, 10)
    posedirs: torch.Tensor     # (21 * 9, V * 3)
    weights: torch.Tensor      # (V, 22)
    j_template: torch.Tensor   # (22, 3)
    j_shapedirs: torch.Tensor  # (22, 3, 10)
    parents: Tuple[int, ...]
    marker_rows: torch.Tensor  # (12,)
    helper_rows: torch.Tensor  # (12,)
    faces: torch.Tensor        # (K, 3) faces around the sensors, in subset rows
    sensor_faces: torch.Tensor  # (12, D) indices into faces, -1 padded

    def to(self, device) -> "SensorBody":
        return SensorBody(**{k: (v.to(device) if torch.is_tensor(v) else v)
                             for k, v in self.__dict__.items()})


def sensor_body(npz: Dict[str, np.ndarray], vertex_ids: Sequence[int] = VERTEX_IDS) -> SensorBody:
    """The sensor body of an SMPL-H npz dict (AMASS keys), on the CPU."""
    faces = np.asarray(npz["f"], np.int64)
    v_all = np.asarray(npz["v_template"], np.float64)
    vf = vertex_faces(v_all.shape[0], faces)
    around = faces[np.unique(vf[list(vertex_ids)][vf[list(vertex_ids)] >= 0])]
    helpers = []
    for v in vertex_ids:
        helpers.append(int(next(c for c in faces[vf[v, 0]] if c != v)))
    rows = np.unique(np.concatenate([np.asarray(vertex_ids), helpers, around.reshape(-1)]))
    row_of = {int(v): i for i, v in enumerate(rows)}
    sub_faces = np.vectorize(lambda v: row_of[int(v)])(around)
    sf = vertex_faces(len(rows), sub_faces)[[row_of[v] for v in vertex_ids]]

    parents_all = np.asarray(npz["kintree_table"], np.int64)[0].copy()
    parents_all[0] = -1
    parents_all = [int(p) if p < 2 ** 31 else -1 for p in parents_all]
    n_joints = len(parents_all)
    keep = BODY_JOINTS + 1
    # Fold every hand joint's weight into its nearest kept ancestor.
    anc = []
    for j in range(n_joints):
        a = j
        while a >= keep:
            a = parents_all[a]
        anc.append(a)
    fold = np.zeros((n_joints, keep))
    fold[np.arange(n_joints), anc] = 1.0
    weights = np.asarray(npz["weights"], np.float64)[rows] @ fold

    jr = np.asarray(npz["J_regressor"], np.float64)[:keep]
    shapedirs_all = np.asarray(npz["shapedirs"], np.float64)[..., :N_BETAS]
    posedirs_all = np.asarray(npz["posedirs"], np.float64)       # (V, 3, 51 * 9)
    posedirs = posedirs_all[rows][..., :BODY_JOINTS * 9]          # (v, 3, 189)
    posedirs = posedirs.reshape(-1, BODY_JOINTS * 9).T            # (189, v * 3)
    f32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)
    i64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64)
    return SensorBody(
        v_template=f32(v_all[rows]), shapedirs=f32(shapedirs_all[rows]), posedirs=f32(posedirs),
        weights=f32(weights), j_template=f32(jr @ v_all),
        j_shapedirs=f32(np.einsum("jv,vdb->jdb", jr, shapedirs_all)),
        parents=tuple(parents_all[:keep]), marker_rows=i64([row_of[v] for v in vertex_ids]),
        helper_rows=i64([row_of[v] for v in helpers]), faces=i64(sub_faces), sensor_faces=i64(sf))


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation (..., 3, 3), the SMPL convention:
    the angle is the norm of ``aa + 1e-8``."""
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    k = aa / angle
    kx, ky, kz = k.unbind(-1)
    z = torch.zeros_like(kx)
    K = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    return torch.eye(3, dtype=aa.dtype, device=aa.device) + s * K + (1 - c) * (K @ K)


def exp_map(aa: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Angle-axis -> rotation with the squared angle clamped at ``eps``
    (the map of the root normalization)."""
    theta = (aa * aa).sum(-1).clamp(min=eps).sqrt()
    x, y, z = aa.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(aa.shape[:-1] + (3, 3))
    a = (torch.sin(theta) / theta)[..., None, None]
    b = ((1 - torch.cos(theta)) / (theta * theta))[..., None, None]
    return torch.eye(3, dtype=aa.dtype, device=aa.device) + a * K + b * (K @ K)


def log_map(R: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rotation -> angle-axis, sin(angle) kept away from 0 by ``eps``."""
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]).clamp(-1.0, 3.0)
    phi = torch.arccos(0.5 * (tr - 1.0))
    s = torch.sin(phi)
    denom = s.abs().clamp(min=eps) * torch.sign(s) + (s == 0).to(phi.dtype) * eps
    A = (phi / (2.0 * denom))[..., None, None] * (R - R.transpose(-1, -2))
    return torch.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]], -1)


def fk(body: SensorBody, poses: torch.Tensor, betas: torch.Tensor, trans=None):
    """Skinned sensor-subset vertices (B, V, 3) and joints (B, 22, 3).

    :param poses: (B, 66) root and body angle-axis; :param betas: (B, 10)."""
    b = poses.shape[0]
    rot = rodrigues(poses.reshape(b, BODY_JOINTS + 1, 3))
    j_rest = body.j_template + (betas @ body.j_shapedirs.reshape(-1, N_BETAS).T).reshape(b, -1, 3)
    Rg, tg = [rot[:, 0]], [j_rest[:, 0]]
    for j in range(1, BODY_JOINTS + 1):
        p = body.parents[j]
        Rg.append(Rg[p] @ rot[:, j])
        tg.append(tg[p] + (Rg[p] @ (j_rest[:, j] - j_rest[:, p])[..., None])[..., 0])
    R = torch.stack(Rg, 1)
    t = torch.stack(tg, 1)
    t_skin = t - (R @ j_rest[..., None])[..., 0]
    v_rest = body.v_template + (betas @ body.shapedirs.reshape(-1, N_BETAS).T).reshape(b, -1, 3)
    feat = (rot[:, 1:] - torch.eye(3, dtype=poses.dtype, device=poses.device)).reshape(b, -1)
    v_posed = v_rest + (feat @ body.posedirs).reshape(b, -1, 3)
    # Skinning: each vertex's transform is its weights' blend of the joints'.
    A = torch.cat([R.reshape(b, -1, 9), t_skin], -1)             # (B, 22, 12)
    T = torch.einsum("vj,bjk->bvk", body.weights, A)             # (B, V, 12)
    verts = (T[..., :9].reshape(b, -1, 3, 3) @ v_posed[..., None])[..., 0] + T[..., 9:]
    if trans is not None:
        verts = verts + trans[:, None]
        t = t + trans[:, None]
    return verts, t


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def sensors(body: SensorBody, verts: torch.Tensor):
    """Sensor positions (B, 12, 3) and frames (B, 12, 3, 3) on ``verts``."""
    tri = verts[:, body.faces]                                   # (B, K, 3, 3)
    fn = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    valid = (body.sensor_faces >= 0).to(verts.dtype)
    picked = fn[:, body.sensor_faces.clamp(min=0)] * valid[None, ..., None]
    normal = _unit(picked.sum(-2) / valid.sum(-1)[None, :, None])
    pos = verts[:, body.marker_rows]
    tangent = _unit(verts[:, body.helper_rows] - pos)
    third = _unit(torch.linalg.cross(normal, tangent))
    tangent = _unit(torch.linalg.cross(third, normal))
    return pos, torch.stack([tangent, third, normal], -1)


def sensor_readings(body: SensorBody, poses, betas, offset_t, offset_r, trans=None):
    """Sensor positions and orientations with mounting offsets applied, and
    the joints: (B, 12, 3), (B, 12, 3, 3), (B, 22, 3)."""
    verts, joints = fk(body, poses, betas, trans)
    pos, frame = sensors(body, verts)
    return pos + (frame @ offset_t[..., None])[..., 0], frame @ offset_r, joints
