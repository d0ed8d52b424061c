"""The port's training-data synthesis against the JAX package: SO(3) maps,
root normalization, FK + virtual sensors, mounting offsets (fed the JAX
draws), the preprocess function's modes, and the offset noise levels by
their moments.

The JAX side runs its row-major FK (``use_lanes`` off), the parity oracle
of its lane-major program and the algorithm the port has. Tolerance atol
1e-5, rtol 1e-5 (fp32 on both sides); atol 5e-5 for what the virtual sensor
frames feed, as in ``test_torch_bodymodel.py`` (the JAX FK paths sit ~3e-5
from an f64 oracle); atol 1e-4 for the whole preprocess, where the
normalized root (~2e-5 apart) goes through the FK.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empose_tpu.config import Configuration as JConfiguration
from empose_tpu.data import transforms as JT
from empose_tpu.ops import so3 as JS

from empose_tpu_torch.bodymodel.synthetic import make_offset_data
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data import noise as TN
from empose_tpu_torch.data import transforms as TT
from empose_tpu_torch.ops import so3 as TS
from tests.test_torch_checkpoint import sensors  # noqa: F401 (fixture)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
FK_TOL = dict(atol=5e-5, rtol=1e-5)
N, F = 3, 5


def _aa(rng, *shape):
    aa = rng.randn(*shape, 3) * 0.8
    aa[..., 0, :] = [1e-5, 0.0, 0.0]  # near the identity, where the clamps act
    return aa.astype(np.float32)


def _batch(seed):
    rng = np.random.RandomState(seed)
    poses = (rng.randn(N, F, 66) * 0.3).astype(np.float32)
    poses[:, :, :3] = _aa(rng, N, F).reshape(N, F, 3)
    return {"poses": poses, "trans": rng.randn(N, F, 3).astype(np.float32),
            "shapes": (rng.randn(N, 10) * 0.5).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got: dict, want: dict, keys, **tol):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **(tol or TOL))


@pytest.fixture(scope="module")
def offset_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("offsets")
    rng = np.random.RandomState(7)
    files = []
    for subj in ("0402", "0403"):
        path = os.path.join(root, f"{subj}_offsets.npz")
        np.savez(path, **make_offset_data(rng))
        files.append(path)
    return files


def test_so3_exp_and_log_maps_match_jax():
    aa = _aa(np.random.RandomState(0), 4, 6)
    want_r = JS.aa2rot(jnp.asarray(aa))
    got_r = TS.aa2rot(torch.from_numpy(aa))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(TS.rot2aa(got_r).numpy(), np.asarray(JS.rot2aa(want_r)), **TOL)
    np.testing.assert_allclose(TS.so3_rotation_angle(got_r).numpy(),
                               np.asarray(JS.so3_rotation_angle(want_r)), atol=1e-4)
    # The smplx Rodrigues of the FK is not this map: it adds 1e-8, no clamp.
    assert not torch.equal(TS.rodrigues(torch.from_numpy(aa)), got_r)


def test_normalize_root_matches_jax():
    batch = _batch(1)
    want = JT.normalize_root({k: jnp.asarray(v) for k, v in batch.items()})
    got = TT.normalize_root(_torch(batch))
    _close(got, want, ("poses", "trans", "trans_source", "root_pose_source"), atol=2e-5, rtol=1e-5)
    assert torch.equal(got["trans"], torch.zeros(N, F, 3))


@pytest.fixture
def row_major_sensors(sensors, monkeypatch):
    monkeypatch.setattr(sensors[0], "use_lanes", False)
    return sensors


def test_smpl_fk_markers_matches_jax(row_major_sensors):
    j_sensor, t_sensor = row_major_sensors
    batch = _batch(2)
    want = JT.smpl_fk_markers(j_sensor, {k: jnp.asarray(v) for k, v in batch.items()})
    got = TT.smpl_fk_markers(t_sensor, _torch(batch))
    _close(got, want, ("joints_gt", "marker_pos_vertex", "marker_ori_vertex", "marker_nor_vertex"),
           **FK_TOL)


def _jax_draws(key, n, f, bank, noise_level):
    """The draws ``JT.sample_markers_with_offsets`` makes from ``key``."""
    k_subj, k_noise = jax.random.split(key)
    s_idx = jax.random.randint(k_subj, (n,), 0, bank.n_subjects)
    z = None
    if noise_level in (0, 1):
        shape = (n, bank.n_markers, 3) if noise_level == 0 else (n, f, bank.n_markers, 3)
        z = jax.random.normal(k_noise, shape)
    return s_idx, z


@pytest.mark.parametrize("noise_level", [-1, 0, 1, 2, 3])
def test_sample_markers_with_offsets_fed_jax_draws(row_major_sensors, offset_files, noise_level):
    j_sensor, t_sensor = row_major_sensors
    batch = _batch(3)
    j_bank = JT.OffsetBank.from_offset_files(offset_files)
    t_bank = TT.OffsetBank.from_offset_files(offset_files)
    for name in ("means", "chol", "r"):
        np.testing.assert_array_equal(getattr(t_bank, name).numpy(), np.asarray(getattr(j_bank, name)))
    j_in = JT.smpl_fk_markers(j_sensor, {k: jnp.asarray(v) for k, v in batch.items()})
    key = jax.random.PRNGKey(noise_level + 10)
    want = JT.sample_markers_with_offsets(j_in, j_bank, key, noise_level, randomize=True)
    s_idx, z = _jax_draws(key, N, F, j_bank, noise_level)
    t_in = {k: torch.from_numpy(np.array(v)) for k, v in j_in.items()}
    got = TT.sample_markers_with_offsets(
        t_in, t_bank, torch.from_numpy(np.array(s_idx)).long(),
        None if z is None else torch.from_numpy(np.array(z)), noise_level, randomize=True)
    _close(got, want, ("marker_pos", "marker_ori", "marker_nor", "offset_t", "offset_r"), **FK_TOL)


@pytest.mark.parametrize("noise_level", [0, 1, 2, 3])
def test_offset_noise_levels_by_moments(offset_files, noise_level):
    """With the raw frames at the origin with identity orientation, the
    marker positions are the sampled local offsets: their mean and
    covariance per marker are the subject's (levels 0 and 1, within 5
    standard errors), zero at levels 2 and 3; level 3 also resets the
    orientation offsets to the identity."""
    bank = TT.OffsetBank.from_offset_files(offset_files[:1])
    n, f = (4000, 1) if noise_level == 0 else (100, 40)
    m = bank.n_markers
    batch = {"poses": torch.zeros(n, f, 66),
             "marker_pos_vertex": torch.zeros(n, f, m * 3),
             "marker_ori_vertex": torch.eye(3).expand(n, f, m, 3, 3).reshape(n, f, -1)}
    g = torch.Generator().manual_seed(noise_level)
    s_idx, z = TT.draw_offset_noise(bank, n, f, g, noise_level, randomize=True)
    out = TT.sample_markers_with_offsets(batch, bank, s_idx, z, noise_level, randomize=True)
    samples = out["marker_pos"].reshape(n * f, m, 3).double()
    if noise_level in (2, 3):
        assert torch.equal(samples, torch.zeros_like(samples))
        want_r = torch.eye(3).expand(n, m, 3, 3) if noise_level == 3 else bank.r[s_idx]
        assert torch.equal(out["offset_r"], want_r)
        return
    means = bank.means[0].double()
    cov = (bank.chol[0] @ bank.chol[0].transpose(-1, -2)).double()
    count = samples.shape[0]
    std = cov.diagonal(dim1=-2, dim2=-1).sqrt()
    assert ((samples.mean(0) - means).abs() <= 5 * std / count ** 0.5).all()
    centered = samples - samples.mean(0)
    emp_cov = torch.einsum("kma,kmb->mab", centered, centered) / (count - 1)
    # Standard error of a covariance entry: sqrt((s_aa s_bb + s_ab^2) / count).
    se = ((std[:, :, None] ** 2 * std[:, None, :] ** 2 + cov ** 2) / count).sqrt()
    assert ((emp_cov - cov).abs() <= 5 * se).all()


@pytest.mark.parametrize("mode", ["all", "normalize_only", "after_normalize"])
def test_preprocess_modes_match_jax(row_major_sensors, offset_files, mode):
    """One subject and no randomization: the draws cannot differ, so the
    whole preprocess function compares with the JAX package's."""
    j_sensor, t_sensor = row_major_sensors
    cfg = dict(use_real_offsets=True, offset_noise_level=0, n_markers=12)
    j_pre = JT.make_preprocess_fn(j_sensor, JT.OffsetBank.from_offset_files(offset_files[:1]),
                                  JConfiguration.from_dict(cfg), False)
    t_pre = TT.make_preprocess_fn(t_sensor, TT.OffsetBank.from_offset_files(offset_files[:1]),
                                  Configuration.from_dict(cfg), False)
    batch = _batch(4)
    batch["seq_lengths"] = np.array([F, 2, 0], np.int32)
    want = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), mode=mode)
    got = t_pre(_torch(batch), torch.Generator().manual_seed(0), mode=mode)
    assert sorted(got) == sorted(want)
    _close(got, want, [k for k in want if k != "seq_lengths"], atol=1e-4, rtol=1e-5)


def test_noise_branches_not_ported_raise():
    """The two noise branches, which raised until the noise functions were
    ported, now run: each changes the sensors of a batch (their parity with
    the JAX package: ``tests/test_torch_noise.py``); no noise is the
    identity."""
    base = dict(spherical_noise_length=0.0, suppression_noise_length=0.0)
    assert TN.make_noise_fn(Configuration.from_dict(base), True)({"x": 1}, None) == {"x": 1}
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randn(N, F, 12 * w).astype(np.float32))
             for k, w in (("marker_pos", 3), ("marker_ori", 9), ("marker_nor", 3))}
    for flag in ("spherical_noise_length", "suppression_noise_length"):
        cfg = dict(base, spherical_noise_strength=0.5, **{flag: 0.5})
        out = TN.make_noise_fn(Configuration.from_dict(cfg), True)(
            batch, torch.Generator().manual_seed(0))
        assert not torch.equal(out["marker_pos"], batch["marker_pos"]), flag
