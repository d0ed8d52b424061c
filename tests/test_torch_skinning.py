"""The port's full-mesh LBS (plain version of the CUDA kernel) against the JAX package.

References: ``empose_tpu.ops.skinning.PallasLBS`` in Pallas interpret mode
and ``lbs_apply_xla``; ``smplh_fk`` with the interpret-mode kernel as its
``lbs_fn`` at the full synthetic mesh. Tolerance atol 2e-5, the JAX test's
(``tests/test_skinning.py``): fp32 on both sides, another summation order,
coordinates of about a metre.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from empose_tpu.bodymodel.smplh import load_smplh as j_load_smplh, smplh_fk as j_smplh_fk
from empose_tpu.ops import skinning as JSK

from empose_tpu_torch.bodymodel.smplh import load_smplh, smplh_fk
from empose_tpu_torch.ops import skinning as SK

torch.set_num_threads(1)
ATOL = 2e-5


def _case(n, v, j, seed):
    """Normalized random weights, random rotations, metre-scale vertices."""
    rng = np.random.RandomState(seed)
    weights = rng.rand(v, j).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    R = Rotation.random(n * j, random_state=seed + 1).as_matrix().astype(np.float32)
    t = rng.randn(n, j, 3).astype(np.float32)
    v_posed = rng.randn(n, v, 3).astype(np.float32)
    return weights, R.reshape(n, j, 3, 3), t, v_posed


def test_plain_matches_pallas_interpret_and_xla():
    weights, R, t, v_posed = _case(2, 700, 52, seed=0)  # 700: not a tile multiple
    j_args = [jnp.asarray(a) for a in (R, t, v_posed)]
    want_xla = np.asarray(JSK.lbs_apply_xla(jnp.asarray(weights), *j_args))
    want_pallas = np.asarray(JSK.PallasLBS(weights)(*j_args, interpret=True))
    got = SK.lbs_apply_plain(*(torch.from_numpy(a) for a in (weights, R, t, v_posed)))
    assert got.shape == (2, 700, 3)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL)


def test_fused_on_cpu_is_the_plain_version():
    weights, R, t, v_posed = _case(3, 129, 52, seed=2)
    args = [torch.from_numpy(a) for a in (R, t, v_posed)]
    launches = SK.LBS_LAUNCHES
    got = SK.FusedLBS(weights, "cpu")(*args)
    assert SK.LBS_LAUNCHES == launches  # CPU tensors: the plain version, no launch
    want = SK.lbs_apply_plain(torch.from_numpy(weights), *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_pack_transforms_matches_jax():
    _, R, t, _ = _case(2, 8, 52, seed=3)
    want = np.asarray(JSK.pack_transforms(jnp.asarray(R), jnp.asarray(t)))
    got = SK.pack_transforms(torch.from_numpy(R), torch.from_numpy(t))
    assert got.shape == (2, 12, 52)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_rejects_other_devices():
    weights, R, t, v_posed = _case(1, 16, 52, seed=4)
    meta = [torch.from_numpy(a).to("meta") for a in (weights.T.copy(), R, t, v_posed)]
    with pytest.raises(ValueError, match="no LBS kernel"):
        SK.lbs_apply_fused(*meta)


@pytest.fixture(scope="module")
def models(synthetic_smplh_npz, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smpl_skin") / "model.npz")
    np.savez(path, **synthetic_smplh_npz)
    return load_smplh(path), j_load_smplh(path)


def test_smplh_fk_full_mesh_through_lbs(models):
    """Full synthetic mesh (V=6890, J=52): the port's FK with the fused LBS
    (its plain version here) against JAX FK with the interpret-mode kernel."""
    t_model, j_model = models
    rng = np.random.RandomState(1)
    poses_body = (rng.randn(2, 63) * 0.3).astype(np.float32)
    betas = (rng.randn(2, 10) * 0.5).astype(np.float32)
    trans = rng.randn(2, 3).astype(np.float32)
    lbs = JSK.PallasLBS(np.asarray(j_model.weights))
    j_v, j_j = j_smplh_fk(j_model, jnp.asarray(poses_body), jnp.asarray(betas),
                          trans=jnp.asarray(trans),
                          lbs_fn=lambda R, t, vp: lbs(R, t, vp, interpret=True))
    t_v, t_j = smplh_fk(t_model.to("cpu"), torch.from_numpy(poses_body), torch.from_numpy(betas),
                        trans=torch.from_numpy(trans), lbs_fn=SK.FusedLBS(t_model.weights, "cpu"))
    assert t_v.shape == (2, 6890, 3) and t_j.shape == (2, 52, 3)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), atol=ATOL)
    np.testing.assert_allclose(t_j.numpy(), np.asarray(j_j), atol=1e-5)
