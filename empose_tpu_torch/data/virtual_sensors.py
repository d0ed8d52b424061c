"""Virtual EM sensors: positions and local orientation frames at mesh vertices.

Port of ``empose_tpu/data/virtual_sensors.py``. The topology (sub-faces,
incidence, helper vertices) is computed once on the host; the per-frame
part (face normals -> vertex normals -> Gram-Schmidt frames) is torch.
Built for a subset body model, the tables index subset rows, so sensor
synthesis touches only the ~150 vertices it reads.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch

from empose_tpu_torch.ops import mesh as mesh_ops

INDEX_FIELDS = ("marker_rows", "helper_rows", "sub_faces_rows", "vertex_faces")


@dataclass(frozen=True)
class VirtualSensorTables:
    """Static topology for sensor synthesis at fixed vertex ids. Index
    arrays refer to rows of the vertex tensor given to ``virtual_pos_and_rot``."""

    vertex_ids: Tuple[int, ...]  # original mesh ids
    marker_rows: np.ndarray      # (M,) rows of the marker vertices
    helper_rows: np.ndarray      # (M,) rows of the helper vertices
    sub_faces_rows: np.ndarray   # (K, 3) faces in row indices
    vertex_faces: np.ndarray     # (M, MAX_DEG) indices into sub_faces, -1 pad

    @staticmethod
    def build(faces: np.ndarray, vertex_ids: Sequence[int], row_of=None) -> "VirtualSensorTables":
        """Precompute tables from mesh faces (original vertex ids).

        :param row_of: mapping original vertex id -> row in the vertex tensor
          (identity if None).
        """
        vertex_ids = tuple(int(v) for v in vertex_ids)
        sub_faces, vertex_faces = mesh_ops.sub_faces_for_vertices(faces, vertex_ids)
        helpers = mesh_ops.helper_vertices(faces, vertex_ids)
        if row_of is None:
            row_of = lambda v: v
        return VirtualSensorTables(
            vertex_ids=vertex_ids,
            marker_rows=np.asarray([row_of(v) for v in vertex_ids], dtype=np.int64),
            helper_rows=np.asarray([row_of(v) for v in helpers], dtype=np.int64),
            sub_faces_rows=np.vectorize(row_of)(sub_faces).astype(np.int64),
            vertex_faces=vertex_faces.astype(np.int64),
        )

    def required_vertices(self) -> np.ndarray:
        """All original-mesh vertex ids this table reads (identity row map only)."""
        return np.unique(np.concatenate([
            np.asarray(self.vertex_ids, dtype=np.int64),
            self.helper_rows.reshape(-1),
            self.sub_faces_rows.reshape(-1),
        ]))

    def to(self, device) -> "VirtualSensorTables":
        """The same tables with int64 index tensors on ``device``."""
        return replace(self, **{name: torch.as_tensor(getattr(self, name), device=device)
                                for name in INDEX_FIELDS})


def subset_tables(faces: np.ndarray, vertex_ids: Sequence[int]):
    """(required-vertex list, tables in subset rows) for a subset model."""
    req = VirtualSensorTables.build(faces, vertex_ids).required_vertices()
    row_map = {int(v): i for i, v in enumerate(req)}
    return req, VirtualSensorTables.build(faces, vertex_ids, row_of=lambda v: row_map[int(v)])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def virtual_pos_and_rot(vertices: torch.Tensor, tables: VirtualSensorTables):
    """Sensor positions, orientation frames and normals at the marker vertices.

      position = the marker vertex;
      normal   = unnormalized mean of the incident face normals;
      frame    = columns [tangent, normal x tangent, unit normal] by
                 Gram-Schmidt from the direction to the helper vertex.

    :param vertices: (N, V_rows, 3); ``tables`` with tensor indices (``.to``).
    :return: (markers (N, M, 3), frames (N, M, 3, 3), normals (N, M, 3))
    """
    normals_raw, _ = mesh_ops.compute_vertex_and_face_normals(vertices, tables.sub_faces_rows,
                                                              tables.vertex_faces)
    markers = vertices.index_select(1, tables.marker_rows)
    helpers = vertices.index_select(1, tables.helper_rows)
    ns = _unit(normals_raw)
    on_surface = _unit(helpers - markers)
    third_axis = _unit(torch.linalg.cross(ns, on_surface))
    on_surface = _unit(torch.linalg.cross(third_axis, ns))
    frames = torch.stack([on_surface, third_axis, ns], dim=-1)
    return markers, frames, normals_raw
