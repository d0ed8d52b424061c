"""The port's offline datagen against ``scripts/preprocess_amass_3dpw.py``.

Inputs are the AMASS-style tree and 3DPW-style pkl of
``tests/test_preprocess.py``, made from a numpy seed. Resampling is the same
numpy on both sides: bit for bit. The corpora are read with the JAX
package's ``EMRReader``: ids, metas, poses, betas and trans exactly, joints
within 1e-5 (FK in fp32 on both sides, another summation order).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from empose_tpu.bodymodel.synthetic import smooth_random_poses
from empose_tpu.data.emr import EMRReader as JEMRReader
from empose_tpu.ops.quaternions import resample_rotations as j_resample_rotations
from scripts import preprocess_amass_3dpw as JP

from empose_tpu_torch import preprocess as P
from empose_tpu_torch.data.datasets import EMRBatchLoader
from empose_tpu_torch.ops.quaternions import resample_rotations

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def amass_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("amass_raw_torch")
    rng = np.random.RandomState(0)
    for subj in ("SubjectA", "SubjectB"):
        d = root / subj
        d.mkdir()
        for i in range(2):
            nf = 30 + 10 * i
            np.savez(d / f"motion{i}_poses.npz",
                     poses=smooth_random_poses(rng, nf, 156, 0.3),
                     betas=rng.randn(16), trans=smooth_random_poses(rng, nf, 3, 0.2),
                     mocap_framerate=np.asarray(120.0), gender="neutral")
        np.savez(d / "subject_shape.npz", betas=rng.randn(16))  # must be skipped
    np.savez(root / "SubjectA" / "MTR03_poses.npz",  # denylisted
             poses=np.zeros((5, 156)), betas=np.zeros(16), trans=np.zeros((5, 3)),
             mocap_framerate=np.asarray(120.0), gender="neutral")
    return str(root)


@pytest.fixture(scope="module")
def threedpw_tree(tmp_path_factory):
    rng = np.random.RandomState(1)
    d = tmp_path_factory.mktemp("3dpw_raw_torch")
    seq = {
        "poses_60Hz": [smooth_random_poses(rng, 20, 72, 0.3), smooth_random_poses(rng, 20, 72, 0.3)],
        "betas": [rng.randn(10), rng.randn(10)],
        "trans_60Hz": [smooth_random_poses(rng, 20, 3, 0.2), smooth_random_poses(rng, 20, 3, 0.2)],
        "genders": ["f", "m"],
    }
    with open(d / "seq1.pkl", "wb") as f:
        pickle.dump(seq, f)
    return str(d)


def test_resampling_is_bit_for_bit():
    rng = np.random.RandomState(5)
    poses = smooth_random_poses(rng, 37, 66, 0.5).reshape(37, 22, 3)
    poses[5:9] *= -1.0  # sign flips for the continuity fix
    np.testing.assert_array_equal(resample_rotations(poses, 120.0, 60.0),
                                  j_resample_rotations(poses, 120.0, 60.0))
    np.testing.assert_array_equal(resample_rotations(poses, 50.0, 60.0),
                                  j_resample_rotations(poses, 50.0, 60.0))
    trans = smooth_random_poses(rng, 37, 3, 0.2)
    np.testing.assert_array_equal(P.resample_positions(trans, 120.0, 60.0),
                                  JP.resample_positions(trans, 120.0, 60.0))


def _assert_same_corpus(path, j_path):
    got, want = JEMRReader(path), JEMRReader(j_path)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert got.meta(i) == want.meta(i)
        assert got.fields(i) == want.fields(i)
        for field in ("poses", "betas", "trans"):
            np.testing.assert_array_equal(got.read(i, field), want.read(i, field))
        np.testing.assert_allclose(got.read(i, "joints"), want.read(i, "joints"), atol=1e-5)


def test_amass_conversion_matches_jax(amass_tree, assets_env, tmp_path):
    ids = P.get_all_amass_file_ids(amass_tree)
    assert ids == JP.get_all_amass_file_ids(amass_tree) and len(ids) == 4
    out, j_out = str(tmp_path / "t" / "corpus.emr"), str(tmp_path / "j" / "corpus.emr")
    assert P.convert_amass_to_emr(out, amass_tree, device="cpu") == 4
    JP.convert_amass_to_emr(j_out, amass_tree)
    _assert_same_corpus(out, j_out)


def test_3dpw_conversion_matches_jax(threedpw_tree, assets_env, tmp_path):
    out, j_out = str(tmp_path / "t" / "corpus.emr"), str(tmp_path / "j" / "corpus.emr")
    assert P.convert_3dpw_to_emr(out, threedpw_tree, device="cpu") == 2
    JP.convert_3dpw_to_emr(j_out, threedpw_tree)
    _assert_same_corpus(out, j_out)
    r = JEMRReader(out)
    assert [r.meta(i)["gender"] for i in range(2)] == ["female", "male"]


def test_cli_corpus_loads_into_the_port_loader(amass_tree, threedpw_tree, assets_env, tmp_path):
    a_out, p_out = str(tmp_path / "amass.emr"), str(tmp_path / "3dpw.emr")
    fk = P.main(["--amass_in", amass_tree, "--amass_out", a_out, "--threedpw_in", threedpw_tree,
                 "--threedpw_out", p_out, "--device", "cpu"])
    assert fk.frames == sum(JEMRReader(a_out).meta(i)["n_frames"] for i in range(4)) + 40
    loader = EMRBatchLoader(a_out, batch_size=2, window_size=8, shuffle=False)
    batch = next(iter(loader))
    assert batch["poses"].shape[0] == 2
    assert np.isfinite(batch["joints_gt"]).all()
    assert P.main([]) is None  # nothing asked for: help only


def test_device_none_needs_cuda(amass_tree, assets_env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.convert_amass_to_emr(str(tmp_path / "c.emr"), amass_tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.main(["--amass_in", amass_tree, "--amass_out", str(tmp_path / "d.emr")])
