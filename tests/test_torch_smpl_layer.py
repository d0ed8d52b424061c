"""The port's full-mesh ``SMPLLayer`` against the JAX package's, on the same npz.

Synthetic SMPL-H (seed 0) at the full mesh, a non-zero root and translation.
Tolerances: vertices atol 2e-5 (the skinning test's), joints and vertex
normals 1e-5 (fp32 on both sides, another summation order).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empose_tpu.bodymodel.smplh import SMPLLayer as JSMPLLayer, load_smplh as j_load_smplh
from empose_tpu.ops import mesh as j_mesh_ops

from empose_tpu_torch.bodymodel.smplh import SMPLLayer, create_default_smpl_model, load_smplh
from empose_tpu_torch.ops import mesh as mesh_ops
from empose_tpu_torch.ops import skinning as SK

torch.set_num_threads(1)
N = 4


@pytest.fixture(scope="module")
def npz_path(synthetic_smplh_npz, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smpl_layer") / "model.npz")
    np.savez(path, **synthetic_smplh_npz)
    return path


@pytest.fixture(scope="module")
def layers(npz_path):
    return SMPLLayer(load_smplh(npz_path), device="cpu"), JSMPLLayer(j_load_smplh(npz_path))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    poses_body = (rng.randn(N, 63) * 0.3).astype(np.float32)
    betas = (rng.randn(N, 10) * 0.5).astype(np.float32)
    poses_root = (rng.randn(N, 3) * 0.5).astype(np.float32)
    trans = rng.randn(N, 3).astype(np.float32)
    return poses_body, betas, poses_root, trans


@pytest.mark.parametrize("normalize_root", [False, True], ids=["plain_root", "normalized_root"])
def test_fk_matches_jax(layers, inputs, normalize_root):
    layer, j_layer = layers
    launches = SK.LBS_LAUNCHES
    verts, joints = layer.fk(*inputs, normalize_root=normalize_root)
    assert SK.LBS_LAUNCHES == launches  # CPU: the kernel's plain version
    j_verts, j_joints = j_layer.fk(*(jnp.asarray(a) for a in inputs), normalize_root=normalize_root)
    assert verts.shape == (N, 6890, 3) and joints.shape == (N, 52, 3)
    np.testing.assert_allclose(verts.numpy(), np.asarray(j_verts), atol=2e-5)
    np.testing.assert_allclose(joints.numpy(), np.asarray(j_joints), atol=1e-5)


def test_fk_joints_and_call(layers, inputs):
    layer, j_layer = layers
    joints = layer.fk_joints(*inputs)
    np.testing.assert_allclose(joints.numpy(), np.asarray(j_layer.fk_joints(
        *(jnp.asarray(a) for a in inputs))), atol=1e-5)
    _, fk_joints = layer(*inputs)  # __call__ is fk
    np.testing.assert_array_equal(joints.numpy(), fk_joints.numpy())


def test_vertex_normals_and_topology(layers, inputs):
    layer, j_layer = layers
    verts, _ = layer.fk(*inputs)
    ids = [10, 3027, 6000]
    j_verts = jnp.asarray(verts.numpy())
    np.testing.assert_allclose(layer.vertex_normals(verts).numpy(),
                               np.asarray(j_layer.vertex_normals(j_verts)), atol=1e-5)
    np.testing.assert_allclose(layer.vertex_normals(verts, ids).numpy(),
                               np.asarray(j_layer.vertex_normals(j_verts, ids)), atol=1e-5)
    np.testing.assert_array_equal(layer.vertex_faces(), j_layer.vertex_faces())
    np.testing.assert_array_equal(layer.faces, np.asarray(j_layer.faces))


def test_vertex_and_face_normals_match_jax(layers, inputs):
    layer, _ = layers
    verts, _ = layer.fk(*inputs)
    faces, vf = np.asarray(layer.faces, np.int64), layer.vertex_faces()
    vn, fn = mesh_ops.compute_vertex_and_face_normals(verts, torch.as_tensor(faces),
                                                      torch.as_tensor(vf))
    j_vn, j_fn = j_mesh_ops.compute_vertex_and_face_normals(jnp.asarray(verts.numpy()),
                                                            jnp.asarray(faces), jnp.asarray(vf))
    assert vn.shape == (N, 6890, 3) and fn.shape == (N, faces.shape[0], 3)
    np.testing.assert_allclose(vn.numpy(), np.asarray(j_vn), atol=1e-5)
    np.testing.assert_allclose(fn.numpy(), np.asarray(j_fn), atol=1e-5)


def test_vposer_hooks_raise_without_a_model(layers):
    layer, _ = layers
    with pytest.raises(RuntimeError, match="VPoser"):
        layer.vposer_decode(torch.zeros(1, 32))
    with pytest.raises(RuntimeError, match="VPoser"):
        layer.vposer_encode(torch.zeros(1, 63))


def test_create_default_smpl_model_reads_smpl_models(npz_path, tmp_path, monkeypatch):
    d = tmp_path / "smplh_amass" / "neutral"
    d.mkdir(parents=True)
    os.symlink(npz_path, d / "model.npz")
    monkeypatch.setenv("SMPL_MODELS", str(tmp_path))
    layer = create_default_smpl_model(device="cpu")
    assert layer.model.n_vertices == 6890 and layer.num_betas == 10
    monkeypatch.setenv("SMPL_MODELS", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="SMPL_MODELS"):
        create_default_smpl_model(device="cpu")


def test_layer_needs_cuda_unless_asked_for_cpu(npz_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SMPLLayer(load_smplh(npz_path))
