"""The port's full-mesh LBS (plain version of the CUDA kernel) against the JAX package.

References: ``empose_tpu.ops.skinning.PallasLBS`` in Pallas interpret mode
and ``lbs_apply_xla``; ``smplh_fk`` with the interpret-mode kernel as its
``lbs_fn`` at the full synthetic mesh. Tolerance atol 2e-5, the JAX test's
(``tests/test_skinning.py``): fp32 on both sides, another summation order,
coordinates of about a metre. Also the CUDA kernel's launch plan (pure
Python) and the wrapper's operand checks, which run before the device
dispatch and so raise on CPU tensors too.
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


def _block_ranges(plan, n, v):
    """Per block of ``plan``, the (frames, vertices) ranges it skins, as
    ``csrc/lbs.cu`` ``lbs_kernel`` splits the (vertex tile, chunk) units,
    tile-major, evenly among the blocks."""
    chunks = -(-n // SK.CHUNK)
    units = chunks * -(-v // plan.tile_v)
    for b in range(plan.blocks):
        segments = []
        for u in range(b * units // plan.blocks, (b + 1) * units // plan.blocks):
            tile, c = divmod(u, chunks)
            segments.append((range(c * SK.CHUNK, min(n, c * SK.CHUNK + SK.CHUNK)),
                             range(tile * plan.tile_v, min(v, tile * plan.tile_v + plan.tile_v))))
        yield segments


@pytest.mark.parametrize("v", [6890, 700])  # the full mesh; a ragged last vertex tile
@pytest.mark.parametrize("n", [1, 7, 64, 76, 512, 600, 1100])
def test_launch_plan_covers_every_frame_and_vertex_once(n, v):
    plan = SK.lbs_launch_plan(n, v)
    hits = np.zeros((n, v), np.int32)
    for segments in _block_ranges(plan, n, v):
        assert len(segments) * SK.CHUNK <= plan.frames_per_block
        for frames, verts in segments:
            assert len(verts) <= plan.tile_v
            hits[frames.start:frames.stop, verts.start:verts.stop] += 1
    assert (hits == 1).all()
    assert plan.blocks <= plan.blocks_per_sm * SK.SMS  # one wave
    if v == 6890:  # the full mesh fills every SM at every N
        assert plan.blocks >= SK.SMS


def test_launch_plan_fits_shared_memory_and_refuses_empty_shapes():
    for n in (1, 512):
        plan = SK.lbs_launch_plan(n, 6890)
        assert plan.smem_bytes == SK.lbs_smem_bytes(plan.tile_v, 52)
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SK.SM_SHARED_BYTES
    with pytest.raises(ValueError, match="positive sizes"):
        SK.lbs_launch_plan(0, 6890)


def _bad_operands():
    weights, R, t, v_posed = _case(2, 40, 52, seed=5)
    good = dict(weights_t=torch.from_numpy(weights.T.copy()), R_glob=torch.from_numpy(R),
                t_skin=torch.from_numpy(t), v_posed=torch.from_numpy(v_posed))
    R4 = torch.from_numpy(np.concatenate([R, R]))
    t4 = torch.from_numpy(np.concatenate([t, t]))
    return good, {
        "float64": (dict(R_glob=good["R_glob"].double()), "float32"),
        "shape": (dict(t_skin=torch.zeros(2, 52, 4)), "shape"),
        "frames": (dict(v_posed=torch.zeros(3, 40, 3)), "shape"),
        "strided_R": (dict(R_glob=R4[::2]), "contiguous"),
        "strided_t": (dict(t_skin=t4[::2]), "contiguous"),
        "transposed_weights": (dict(weights_t=torch.from_numpy(weights).t()), "shape|contiguous"),
        "weights_view": (dict(weights_t=torch.from_numpy(np.ascontiguousarray(
            np.concatenate([weights.T, weights.T], 1)))[:, ::2]), "contiguous"),
        "rank": (dict(v_posed=torch.zeros(2, 40)), "N, V, 3"),
    }


@pytest.mark.parametrize("case", ["float64", "shape", "frames", "strided_R", "strided_t",
                                  "transposed_weights", "weights_view", "rank"])
def test_fused_checks_operands_on_cpu(case):
    good, bad = _bad_operands()
    change, match = bad[case]
    launches = SK.LBS_LAUNCHES
    with pytest.raises(ValueError, match=match):
        SK.lbs_apply_fused(**dict(good, **change))
    assert SK.LBS_LAUNCHES == launches
    SK.lbs_apply_fused(**good)  # the unchanged operands pass
