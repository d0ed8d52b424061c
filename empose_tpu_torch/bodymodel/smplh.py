"""SMPL-H body model in torch: blendshapes, kinematic-tree FK and LBS.

Port of ``empose_tpu/bodymodel/smplh.py`` (``SMPLHModel``, ``load_smplh``,
``subset``, ``fold_zero_pose_joints``, ``_tree_levels``,
``_rigid_transform_chain``, ``smplh_fk``, ``smplh_fk_normalized_root``,
``SMPLLayer``, ``create_default_smpl_model``). A model keeps host numpy
arrays; ``SMPLHModel.to`` gives the same model with torch tensors on a
device, which is what ``smplh_fk`` evaluates. FK is differentiable (the LGD
loop takes its gradient).

``SMPLLayer`` is the full-mesh API: it puts the model's tables on its device
once and skins the full mesh through the LBS kernel (``ops/skinning.py``).
The sensor, serving and training paths use subset models and never hold the
full mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.device import resolve_device
from empose_tpu_torch.ops import mesh as mesh_ops
from empose_tpu_torch.ops.precision import matmul_at
from empose_tpu_torch.ops.skinning import FusedLBS, lbs_apply_plain
from empose_tpu_torch.ops.so3 import aa2rot, rodrigues, rot2aa
from empose_tpu_torch.utils.precision import HIGHEST

ARRAY_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights",
                 "j_template", "j_shapedirs")


@dataclass(frozen=True)
class SMPLHModel:
    """SMPL-H parameters.

      v_template: (V, 3)     rest-pose template vertices
      shapedirs:  (V, 3, B)  shape blendshapes
      posedirs:   (P, V*3)   pose blendshapes, P = (J-1)*9, pre-transposed
      j_regressor:(J, V)     joint regressor
      weights:    (V, J)     LBS weights
      j_template: (J, 3)     J_regressor @ v_template (precomputed)
      j_shapedirs:(J, 3, B)  J_regressor @ shapedirs  (precomputed)
      parents:    J ints, parents[0] == -1
      faces:      (F, 3) numpy mesh topology
      vertex_ids: original mesh vertex id per row (None = full mesh)

    ``j_template``/``j_shapedirs`` factor the rest-joint regression
    J @ (v_template + shapedirs . beta) so FK never touches the full mesh.
    """

    v_template: object
    shapedirs: object
    posedirs: object
    j_regressor: object
    weights: object
    j_template: object = None
    j_shapedirs: object = None
    parents: Tuple[int, ...] = field(default=())
    faces: Optional[np.ndarray] = field(default=None, repr=False)
    vertex_ids: Optional[Tuple[int, ...]] = field(default=None, repr=False)

    def __post_init__(self):
        if self.j_template is None:
            jr = np.asarray(self.j_regressor, np.float64)
            dtype = np.asarray(self.v_template).dtype
            object.__setattr__(self, "j_template", np.asarray(
                jr @ np.asarray(self.v_template, np.float64), dtype=dtype))
            object.__setattr__(self, "j_shapedirs", np.asarray(
                np.einsum("jv,vdb->jdb", jr, np.asarray(self.shapedirs, np.float64)), dtype=dtype))

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def n_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def to(self, device, dtype=torch.float32) -> "SMPLHModel":
        """The same model with torch tensors on ``device``."""
        return replace(self, **{
            name: torch.as_tensor(np.asarray(getattr(self, name)), dtype=dtype, device=device)
            for name in ARRAY_FIELDS})

    def subset(self, vertex_ids: Sequence[int]) -> "SMPLHModel":
        """Restrict the skinned vertex set to ``vertex_ids`` (rows of all
        per-vertex tables); joints are unaffected."""
        idx = np.asarray(list(vertex_ids), dtype=np.int64)
        v3 = (idx[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
        return replace(
            self,
            v_template=self.v_template[idx],
            shapedirs=self.shapedirs[idx],
            posedirs=self.posedirs[:, v3],
            weights=self.weights[idx],
            vertex_ids=tuple(int(i) for i in idx),
        )


def load_smplh(npz_path: Optional[str] = None, num_betas: int = C.N_SHAPE_PARAMS,
               dtype=np.float32) -> SMPLHModel:
    """Load SMPL-H from the AMASS-style npz (keys v_template, shapedirs,
    posedirs, J_regressor, weights, kintree_table, f) as host arrays."""
    npz_path = npz_path or C.default_smplh_path()
    if not os.path.exists(npz_path):
        raise FileNotFoundError(
            f"SMPL-H model not found at {npz_path}. Set $SMPL_MODELS or write a "
            "synthetic model with empose_tpu_torch.bodymodel.synthetic.make_synthetic_smplh.")
    data = np.load(npz_path, allow_pickle=True)
    v_template = np.asarray(data["v_template"], dtype=np.float64)
    shapedirs = np.asarray(data["shapedirs"], dtype=np.float64)[..., :num_betas]
    posedirs = np.asarray(data["posedirs"], dtype=np.float64)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (V, 3, P) -> (P, V*3)
    j_regressor = np.asarray(data["J_regressor"], dtype=np.float64)
    weights = np.asarray(data["weights"], dtype=np.float64)
    parents = np.asarray(data["kintree_table"], dtype=np.int64)[0].copy()
    parents[0] = -1
    np_dtype = np.dtype(dtype)
    return SMPLHModel(
        v_template=v_template.astype(np_dtype),
        shapedirs=shapedirs.astype(np_dtype),
        posedirs=posedirs.astype(np_dtype),
        j_regressor=j_regressor.astype(np_dtype),
        weights=weights.astype(np_dtype),
        j_template=(j_regressor @ v_template).astype(np_dtype),
        j_shapedirs=np.einsum("jv,vdb->jdb", j_regressor, shapedirs).astype(np_dtype),
        parents=tuple(int(p) for p in parents),
        faces=np.asarray(data["f"], dtype=np.int64),
    )


def fold_zero_pose_joints(model: SMPLHModel, keep: int) -> SMPLHModel:
    """Truncate the tree to the first ``keep`` joints, folding the LBS
    weights of every dropped joint into its nearest kept ancestor.

    Exact for dropped joints whose local rotation is always identity: their
    skinning transform equals their posed ancestor's. The sensor path runs
    SMPL-H with zero hand poses, so folding the 30 hand joints into the
    wrists is lossless there. Host numpy only.
    """
    J = model.n_joints
    if J <= keep:
        return model
    parents = model.parents
    if not all(parents[j] < keep for j in range(1, keep)):
        raise ValueError("the kept prefix must be ancestor-closed")
    anc = list(range(J))
    for j in range(J):
        a = j
        while a >= keep:
            a = parents[a]
        anc[j] = a
    fold = np.zeros((J, keep), np.float64)
    fold[np.arange(J), anc] = 1.0
    weights = np.asarray(np.asarray(model.weights, np.float64) @ fold, model.weights.dtype)
    return replace(
        model,
        posedirs=model.posedirs[: (keep - 1) * 9],
        j_regressor=model.j_regressor[:keep],
        weights=weights,
        j_template=model.j_template[:keep],
        j_shapedirs=model.j_shapedirs[:keep],
        parents=tuple(parents[:keep]),
    )


@lru_cache(maxsize=None)
def _tree_levels(parents: Tuple[int, ...]) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
    """Group joints by depth: ((joint_ids, parent_ids), ...) per level > 0."""
    depth = [0] * len(parents)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    levels = []
    for d in range(1, max(depth) + 1):
        ids = tuple(i for i in range(len(parents)) if depth[i] == d)
        levels.append((ids, tuple(parents[i] for i in ids)))
    return tuple(levels)


@lru_cache(maxsize=None)
def _level_index(parents: Tuple[int, ...], device: torch.device):
    """Index tensors on ``device`` (built once per device) for the level
    schedule: each non-root joint's parent; per level, its joints and its
    parents' positions in level order; each joint's position in level order."""
    levels = _tree_levels(parents)
    order = [0] + [j for ids, _ in levels for j in ids]
    pos = {j: i for i, j in enumerate(order)}
    as_t = lambda xs: torch.tensor(xs, dtype=torch.long, device=device)
    level_t = tuple((as_t(ids), as_t([pos[p] for p in par])) for ids, par in levels)
    return as_t(parents[1:]), level_t, as_t([pos[j] for j in range(len(parents))])


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor, parents: Tuple[int, ...]):
    """Global joint transforms over the tree, one batched product per depth.

    Joints are composed level by level into a level-ordered list and put back
    in joint order once at the end; gathers use ``index_select``, whose
    gradient is a cheap scatter-add (the LGD loop differentiates this).

    :param rot_mats: (N, J, 3, 3); :param joints: (N, J, 3) rest joints.
    :return: posed joints (N, J, 3), global rotations (N, J, 3, 3),
             skinning translations (N, J, 3).
    """
    par_all, levels, inv = _level_index(parents, joints.device)
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints.index_select(1, par_all)], dim=1)
    Rs, ts = [rot_mats[:, :1]], [rel_joints[:, :1]]
    for ids, ppos in levels:
        R_par = torch.cat(Rs, dim=1).index_select(1, ppos)
        t_par = torch.cat(ts, dim=1).index_select(1, ppos)
        Rs.append(R_par @ rot_mats.index_select(1, ids))
        ts.append((R_par @ rel_joints.index_select(1, ids)[..., None])[..., 0] + t_par)
    R = torch.cat(Rs, dim=1).index_select(1, inv)
    t = torch.cat(ts, dim=1).index_select(1, inv)
    t_skin = t - (R @ joints[..., None])[..., 0]
    return t, R, t_skin


def smplh_fk(model: SMPLHModel, poses_body: torch.Tensor, betas: torch.Tensor,
             poses_root: Optional[torch.Tensor] = None, trans: Optional[torch.Tensor] = None,
             poses_hands: Optional[torch.Tensor] = None, want_vertices: bool = True,
             lbs_fn=None, precision: str = HIGHEST):
    """Evaluate SMPL-H on a tensor model (``SMPLHModel.to``).

    Hand poses default to zero, root/trans to zero; betas broadcast over the
    batch and are truncated to the model's beta count. ``lbs_fn(R_glob,
    t_skin, v_posed)``, when given, does the skinning (the full-mesh kernel,
    ``ops/skinning.FusedLBS``); otherwise its plain version
    (``ops/skinning.lbs_apply_plain``) does.

    ``precision`` is the mode of the joint-regressor, shape-blend,
    pose-blend and (without ``lbs_fn``) skinning blend products, the GEMMs
    of ``empose_tpu/ops/fk_lanes.py``; ``SensorSMPL.markers_and_joints``
    passes the kinematics knob. The rotation compose and the full-mesh LBS
    stay f32 at every mode, as in JAX.

    :param poses_body: (N, 63+) body pose angle-axis (extra dofs ignored).
    :param betas: (N, B) or (B,) or (1, B).
    :return: (vertices (N, V_subset, 3) or None, joints (N, J, 3))
    """
    n = poses_body.shape[0]
    dtype, device = model.v_template.dtype, model.v_template.device
    poses_body = poses_body[:, : C.N_JOINTS * 3].to(dtype)
    if poses_root is None:
        poses_root = torch.zeros(n, 3, dtype=dtype, device=device)
    if trans is None:
        trans = torch.zeros(n, 3, dtype=dtype, device=device)
    if poses_hands is None:
        poses_hands = torch.zeros(n, (model.n_joints - 1 - C.N_JOINTS) * 3, dtype=dtype, device=device)
    if betas.ndim == 1:
        betas = betas[None]
    if betas.shape[0] == 1:
        betas = betas.expand(n, betas.shape[1])
    betas = betas[:, : model.n_betas].to(dtype)

    full_pose = torch.cat([poses_root.to(dtype), poses_body, poses_hands.to(dtype)], dim=-1)
    rot_mats = rodrigues(full_pose.reshape(n, model.n_joints, 3))
    nb = betas.shape[1]
    j_rest = model.j_template[None] + matmul_at(
        betas, model.j_shapedirs.reshape(-1, nb).t(), precision).reshape(n, -1, 3)
    joints_posed, R_glob, t_skin = _rigid_transform_chain(rot_mats, j_rest, model.parents)
    joints_out = joints_posed + trans[:, None]
    if not want_vertices:
        return None, joints_out

    v_rest = model.v_template[None] + matmul_at(
        betas, model.shapedirs.reshape(-1, nb).t(), precision).reshape(n, -1, 3)
    ident = torch.eye(3, dtype=dtype, device=device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(n, -1)
    v_posed = v_rest + matmul_at(pose_feature, model.posedirs, precision).reshape(n, -1, 3)
    if lbs_fn is None:
        return (lbs_apply_plain(model.weights, R_glob, t_skin, v_posed, precision)
                + trans[:, None], joints_out)
    return lbs_fn(R_glob, t_skin, v_posed) + trans[:, None], joints_out


def smplh_fk_normalized_root(model: SMPLHModel, poses_body, betas, poses_root, trans, **kw):
    """FK with the root normalized to frame 0: frame 0's root orientation
    becomes the identity and its translation the origin. Time runs along the
    leading axis (one sequence)."""
    root_ori = aa2rot(poses_root)
    first_inv = root_ori[0:1].transpose(-1, -2)
    poses_root = rot2aa(first_inv @ root_ori)
    trans = trans @ first_inv[0].T
    return smplh_fk(model, poses_body, betas, poses_root, trans - trans[0:1], **kw)


class SMPLLayer:
    """The full-mesh body-model API (``empose_tpu/bodymodel/smplh.py::SMPLLayer``).

    The model's tables (~40 MB at the full mesh) go to ``device`` once, here;
    a full-mesh model skins through the LBS kernel (``FusedLBS``; on the CPU
    its plain version), a subset model through plain einsums. Inputs are
    tensors or arrays, moved to the layer's device; results stay there.
    ``window_size`` is accepted for the reference's API and ignored.
    """

    vposer = None  # an (encode, decode) pair enables the VPoser hooks

    def __init__(self, model: SMPLHModel, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.num_betas = model.n_betas
        self._model_dev = model.to(self.device)
        self._lbs = FusedLBS(model.weights, self.device) if model.vertex_ids is None else None
        self._faces_dev = None

    def _as_tensor(self, x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @property
    def faces(self) -> np.ndarray:
        return self.model.faces

    def vertex_faces(self) -> np.ndarray:
        """Vertex -> incident faces table of the full mesh (-1 padded)."""
        if self.model.vertex_ids is not None:
            raise ValueError("vertex_faces needs the full mesh, not a subset model")
        return mesh_ops.vertex_face_indices(self.model.n_vertices, self.model.faces)

    def fk(self, poses_body, betas, poses_root=None, trans=None, normalize_root=False,
           window_size=None):
        """:return: (vertices (N, V, 3), joints (N, J, 3)) on the layer's device."""
        poses_body, betas = self._as_tensor(poses_body), self._as_tensor(betas)
        poses_root, trans = self._as_tensor(poses_root), self._as_tensor(trans)
        if normalize_root:
            return smplh_fk_normalized_root(self._model_dev, poses_body, betas, poses_root,
                                            trans, lbs_fn=self._lbs)
        return smplh_fk(self._model_dev, poses_body, betas, poses_root, trans, lbs_fn=self._lbs)

    def fk_joints(self, poses_body, betas, poses_root=None, trans=None) -> torch.Tensor:
        """Joints only (N, J, 3): no blendshapes, no skinning."""
        return smplh_fk(self._model_dev, self._as_tensor(poses_body), self._as_tensor(betas),
                        self._as_tensor(poses_root), self._as_tensor(trans),
                        want_vertices=False)[1]

    def vertex_normals(self, vertices, output_vertex_ids=None) -> torch.Tensor:
        """Unnormalized vertex normals over the full mesh (N, V or len(ids), 3)."""
        if self._faces_dev is None:
            self._faces_dev = (torch.as_tensor(np.asarray(self.faces), device=self.device),
                               torch.as_tensor(self.vertex_faces(), device=self.device))
        normals, _ = mesh_ops.compute_vertex_and_face_normals(self._as_tensor(vertices),
                                                              *self._faces_dev)
        if output_vertex_ids is not None:
            normals = normals[:, torch.as_tensor(output_vertex_ids, device=self.device)]
        return normals

    def vposer_decode(self, poZ_body):
        if self.vposer is None:
            raise RuntimeError("No VPoser model attached.")
        return self.vposer[1](poZ_body)

    def vposer_encode(self, pose_body):
        if self.vposer is None:
            raise RuntimeError("No VPoser model attached.")
        return self.vposer[0](pose_body)

    def __call__(self, *args, **kwargs):
        return self.fk(*args, **kwargs)


def create_default_smpl_model(npz_path: Optional[str] = None, device=None) -> SMPLLayer:
    """The SMPL-H of ``$SMPL_MODELS`` (or ``npz_path``) as an ``SMPLLayer``."""
    return SMPLLayer(load_smplh(npz_path), device)
