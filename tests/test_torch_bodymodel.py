"""The port's SMPL-H FK and virtual sensors against the JAX package.

Both JAX paths are references: the row-major ``markers_and_joints_row_major``
path and the lane-major ``LaneFK``. Synthetic SMPL-H (seed 0), non-identity
mounting offsets and a non-zero root. Tolerance atol 5e-5: the two JAX paths
already sit ~3e-5 from an f64 oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empose_tpu.bodymodel.smplh import load_smplh as j_load_smplh, smplh_fk as j_smplh_fk
from empose_tpu.bodymodel.synthetic import make_offset_data
from empose_tpu.nn.models import SensorSMPL as JSensorSMPL

from empose_tpu_torch.bodymodel.smplh import load_smplh, smplh_fk
from empose_tpu_torch.nn.models import SensorSMPL

torch.set_num_threads(1)
ATOL = 5e-5
B = 12


@pytest.fixture(scope="module")
def models(synthetic_smplh_npz, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smpl_torch") / "model.npz")
    np.savez(path, **synthetic_smplh_npz)
    return load_smplh(path), j_load_smplh(path)


@pytest.fixture(scope="module")
def sensors(models):
    """(port sensor, {lanes: JAX sensor}) built once for the module."""
    t_model, j_model = models
    j_sensors = {}
    for lanes in (False, True):
        j_sensors[lanes] = JSensorSMPL(j_model)
        j_sensors[lanes].use_lanes = lanes
    return SensorSMPL(t_model), j_sensors


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    poses = (rng.randn(B, 66) * 0.4).astype(np.float32)
    poses[:, :3] += np.array([0.3, -1.2, 0.5], np.float32)  # non-zero root
    shapes = (rng.randn(B, 10) * 0.8).astype(np.float32)
    off = make_offset_data(rng)
    offset_r = np.broadcast_to(off["r"].astype(np.float32), (B, 12, 3, 3)).copy()
    offset_t = np.broadcast_to(off["means"].astype(np.float32), (B, 12, 3)).copy()
    return poses, shapes, offset_r, offset_t


def test_smplh_fk_joints_and_vertices(models, inputs):
    t_model, j_model = models
    poses, shapes, _, _ = inputs
    trans = np.linspace(-1, 1, B * 3, dtype=np.float32).reshape(B, 3)
    ids = [3027, 3748, 10, 6000]
    j_v, j_j = j_smplh_fk(j_model.subset(ids), jnp.asarray(poses[:, 3:]), jnp.asarray(shapes),
                          jnp.asarray(poses[:, :3]), jnp.asarray(trans))
    t_v, t_j = smplh_fk(t_model.subset(ids).to("cpu"), torch.from_numpy(poses[:, 3:]),
                        torch.from_numpy(shapes), torch.from_numpy(poses[:, :3]),
                        torch.from_numpy(trans))
    assert t_j.shape == (B, 52, 3) and t_v.shape == (B, 4, 3)
    np.testing.assert_allclose(t_j.numpy(), np.asarray(j_j), atol=ATOL)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), atol=ATOL)


@pytest.mark.parametrize("lanes", [False, True], ids=["row_major", "lane_fk"])
def test_estimated_markers(sensors, inputs, lanes):
    t_sensor, j_sensors = sensors
    j_sensor = j_sensors[lanes]
    poses, shapes, offset_r, offset_t = inputs
    # Eager, as the JAX package's own tests run it: under jit XLA's fusion
    # moves the lane path another ~2e-6 away.
    want = j_sensor.estimated_markers(jnp.asarray(poses), jnp.asarray(shapes),
                                      jnp.asarray(offset_r), jnp.asarray(offset_t))
    got = t_sensor.estimated_markers(torch.from_numpy(poses), torch.from_numpy(shapes),
                                     torch.from_numpy(offset_r), torch.from_numpy(offset_t))
    for g, w, shape in zip(got, want, [(B, 12, 3), (B, 12, 3, 3), (B, 22, 3)]):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("lanes", [False, True], ids=["row_major", "lane_fk"])
def test_estimated_markers_gradient(sensors, inputs, lanes):
    """The LGD input is a gradient through FK + sensors: torch autograd ==
    jax.grad of the same scalar, w.r.t. pose and shape."""
    t_sensor, j_sensors = sensors
    j_sensor = j_sensors[lanes]
    poses, shapes, offset_r, offset_t = inputs
    rng = np.random.RandomState(1)
    w_pos = rng.randn(B, 12, 3).astype(np.float32)
    w_ori = rng.randn(B, 12, 3, 3).astype(np.float32)

    def j_scalar(p, s):
        pos, ori, _ = j_sensor.estimated_markers(p, s, jnp.asarray(offset_r), jnp.asarray(offset_t))
        return jnp.sum(pos * w_pos) + jnp.sum(ori * w_ori)

    jg_p, jg_s = jax.jit(jax.grad(j_scalar, argnums=(0, 1)))(jnp.asarray(poses),
                                                              jnp.asarray(shapes))
    p = torch.from_numpy(poses).requires_grad_()
    s = torch.from_numpy(shapes).requires_grad_()
    pos, ori, _ = t_sensor.estimated_markers(p, s, torch.from_numpy(offset_r),
                                             torch.from_numpy(offset_t))
    tg_p, tg_s = torch.autograd.grad((pos * torch.from_numpy(w_pos)).sum()
                                     + (ori * torch.from_numpy(w_ori)).sum(), (p, s))
    # Gradients reach |g| ~ 40 here and sum many fp32 terms, so the tolerance
    # is ATOL relative to each gradient's largest entry (the row-major and
    # lane JAX paths themselves differ by ~2e-5 of it).
    for got, want in ((tg_p, jg_p), (tg_s, jg_s)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL * np.abs(want).max())
