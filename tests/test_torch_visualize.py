"""The port's ``export_visualization`` against the JAX harness's.

One sequence of 20 frames with a predicted pose and shape, synthetic SMPL-H
at the full mesh; the port's FK chunk is cut to 8 frames so that the export
runs three chunks per pose track. The npz arrays agree within 2e-5
(full-mesh vertices, the skinning tolerance), the OBJ faces are identical
and the parsed OBJ vertices agree within 1e-5 (6 decimals printed).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from empose_tpu.bodymodel.smplh import load_smplh as j_load_smplh
from empose_tpu.bodymodel.synthetic import smooth_random_poses
from empose_tpu.eval.harness import export_visualization as j_export_visualization

from empose_tpu_torch.bodymodel.smplh import SMPLLayer, load_smplh
from empose_tpu_torch.eval import harness

torch.set_num_threads(1)
F = 20


def _read_obj(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    verts = np.array([r[1:] for r in rows if r[0] == "v"], np.float64)
    faces = np.array([r[1:] for r in rows if r[0] == "f"], np.int64)
    return verts, faces


@pytest.mark.parametrize("body", ["layer", "full_model"])
def test_export_matches_jax(synthetic_smplh_npz, tmp_path, monkeypatch, body):
    monkeypatch.setattr(harness, "VIS_CHUNK", 8)
    path = str(tmp_path / "model.npz")
    np.savez(path, **synthetic_smplh_npz)
    rng = np.random.RandomState(4)
    poses = smooth_random_poses(rng, F + 6, 66, 0.3).astype(np.float32)
    host_batch = {"seq_lengths": np.array([F]), "poses": poses[None],
                  "shapes": (rng.randn(1, 10) * 0.5).astype(np.float32)}
    pose_hat = (poses + rng.randn(*poses.shape) * 0.05).astype(np.float32)
    shape_hat = (rng.randn(10) * 0.5).astype(np.float32)

    j_npz = j_export_visualization(SimpleNamespace(full=j_load_smplh(path)), "seq", host_batch,
                                   pose_hat, shape_hat, str(tmp_path / "jax"))
    model = load_smplh(path)
    smpl = SMPLLayer(model, device="cpu") if body == "layer" else SimpleNamespace(full=model)
    npz = harness.export_visualization(smpl, "seq", host_batch, pose_hat, shape_hat,
                                       str(tmp_path / "port"), device="cpu")

    got, want = np.load(npz), np.load(j_npz)
    assert sorted(got.files) == sorted(want.files)
    assert got["verts_gt"].shape == (F, 6890, 3) and got["joints_hat"].shape == (F, 22, 3)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)
    for name in ("seq_frame0_gt.obj", "seq_frame0_pred.obj"):
        v, f = _read_obj(os.path.join(tmp_path, "port", name))
        j_v, j_f = _read_obj(os.path.join(tmp_path, "jax", name))
        np.testing.assert_array_equal(f, j_f)
        np.testing.assert_allclose(v, j_v, atol=1e-5)
