"""Mesh topology tables (host numpy) and vertex and face normals (torch).

Port of ``empose_tpu/ops/mesh.py``. The tables are computed once on the host
from the face array; only the normals run per frame.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def vertex_face_indices(n_vertices: int, faces: np.ndarray) -> np.ndarray:
    """For each vertex, the ids of its incident faces, padded with -1.

    A (V, MAX_DEGREE) int array; face ids per row ascend (stable sort over
    the flattened face array), as ``trimesh.Trimesh.vertex_faces`` has them.
    """
    faces = np.asarray(faces, dtype=np.int64)
    flat = faces.reshape(-1)
    counts = np.bincount(flat, minlength=n_vertices)
    max_deg = int(counts.max()) if counts.size else 0
    order = np.argsort(flat, kind="stable")
    face_ids = order // 3
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = -np.ones((n_vertices, max_deg), dtype=np.int64)
    for v in range(n_vertices):
        c = counts[v]
        if c:
            out[v, :c] = face_ids[starts[v]:starts[v] + c]
    return out


def sub_faces_for_vertices(faces: np.ndarray, vertex_ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Faces incident to any of ``vertex_ids`` and each vertex's incidence into them.

    :return: (sub_faces (K, 3) in ORIGINAL vertex ids,
              vertex_faces (len(vertex_ids), MAX_DEG) indexing into sub_faces, -1 padded)
    """
    faces = np.asarray(faces, dtype=np.int64)
    v_ids = list(vertex_ids)
    vf_full = vertex_face_indices(int(faces.max()) + 1, faces)
    picked = vf_full[v_ids]
    sub = faces[np.unique(picked[picked != -1])]
    vf_sub = vertex_face_indices(int(sub.max()) + 1, sub)[v_ids]
    return sub, vf_sub


def helper_vertices(faces: np.ndarray, vertex_ids: Sequence[int]) -> list:
    """For each vertex, the first other vertex of its first incident face
    (anchors the sensor frame's tangent direction)."""
    faces = np.asarray(faces, dtype=np.int64)
    vf = vertex_face_indices(int(faces.max()) + 1, faces)
    helpers = []
    for v in vertex_ids:
        for cand in faces[vf[v, 0]]:
            if cand != v:
                helpers.append(int(cand))
                break
    return helpers


def compute_vertex_and_face_normals(vertices: torch.Tensor, faces: torch.Tensor,
                                    vertex_faces: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized vertex normals (the mean of the incident face normals)
    and face normals.

    :param vertices: (N, V, 3); :param faces: (F, 3) int64;
    :param vertex_faces: (Q, MAX_DEG) face ids per queried vertex, -1 padded.
    :return: vertex normals (N, Q, 3) and face normals (N, F, 3).
    """
    n = vertices.shape[0]
    vs = vertices.index_select(1, faces.reshape(-1)).reshape(n, -1, 3, 3)  # (N, F, 3, 3)
    face_normals = torch.linalg.cross(vs[:, :, 1] - vs[:, :, 0], vs[:, :, 2] - vs[:, :, 0])
    valid = vertex_faces >= 0
    gathered = face_normals.index_select(1, vertex_faces.clamp(min=0).reshape(-1))
    gathered = gathered.reshape(n, *vertex_faces.shape, 3) * valid[None, :, :, None]
    degrees = valid.sum(-1).to(vertices.dtype)
    return gathered.sum(-2) / degrees[None, :, None], face_normals
