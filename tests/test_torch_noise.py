"""The port's sensor-fault noise against the JAX package
(``empose_tpu/data/noise.py``).

Each apply half of the port is fed the draws that the JAX function makes
from its key (its ``jax.random.split`` and draws replayed here) and must
give the JAX function's output: suppression bit for bit, spherical within
1e-6 (the trigonometry of two libraries). The port's own draws are held by
their moments (5 standard errors), the branch table of ``make_noise_fn``
against JAX's, and the noise inside the preprocess function against the
clean preprocess followed by the noise from the same generator state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empose_tpu import constants as JC
from empose_tpu.config import Configuration as JConfiguration
from empose_tpu.data import noise as JN

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data import noise as TN
from empose_tpu_torch.data import transforms as TT
from tests.test_torch_checkpoint import sensors  # noqa: F401 (fixture)
from tests.test_torch_datagen import _batch, offset_files, row_major_sensors  # noqa: F401

torch.set_num_threads(1)
SPHERICAL_TOL = 1e-6
N, F = 4, 12
LENGTHS = {"full": [F, F, F, F], "ragged": [F, 0, 3, F - 1], "none": None}


def _sensor_batch(seed: int, m: int, lengths):
    rng = np.random.RandomState(seed)
    batch = {"marker_pos": rng.randn(N, F, m * 3).astype(np.float32),
             "marker_ori": rng.randn(N, F, m * 9).astype(np.float32),
             "marker_nor": rng.randn(N, F, m * 3).astype(np.float32),
             "marker_masks": (rng.rand(N, F, m) > 0.2).astype(np.float32)}
    if lengths is not None:
        batch["seq_lengths"] = np.asarray(lengths, np.int32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _spherical_draws(key, n, f, m, k):
    """The draws of ``spherical_marker_noise_fn``'s apply (noise.py:75-86)."""
    k_ids, k_sf, k_r, k_theta, k_phi = jax.random.split(key, 5)
    draws = {"perm": jax.random.permutation(k_ids, m), "u": jax.random.uniform(k_sf, (n,)),
             "r": jax.random.uniform(k_r, (n, f, k)),
             "theta": jax.random.uniform(k_theta, (n, f, k)),
             "phi": jax.random.uniform(k_phi, (n, f, k))}
    return {name: torch.from_numpy(np.array(v)) for name, v in draws.items()}


def _suppression_draws(key, n, k, n_candidates):
    """The draws of ``marker_suppression_noise_fn``'s apply (noise.py:134-137)."""
    k_ids, k_sf = jax.random.split(key)
    choice = jax.random.randint(k_ids, (n, k), 0, n_candidates)
    u = jax.random.uniform(k_sf, (n,))
    return torch.from_numpy(np.array(choice)).long(), torch.from_numpy(np.array(u))


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("mask_value", [0.0, -1.0])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("m", [6, 12])
def test_suppression_fed_jax_draws_is_bit_exact(m, k, mask_value, lengths):
    batch = _sensor_batch(m + k, 12, LENGTHS[lengths])
    key = jax.random.PRNGKey(100 + m + k)
    want = JN.marker_suppression_noise_fn(0.5, k, mask_value, m)(_jax(batch), key)
    choice, u = _suppression_draws(key, N, k, 6 if m == 6 else 12)
    got = TN.marker_suppression_noise(_torch(batch), choice, u, 0.5, mask_value, m)
    assert sorted(got) == sorted(want)
    changed = 0
    for name in ("marker_pos", "marker_ori", "marker_nor", "marker_masks"):
        assert torch.equal(got[name], torch.from_numpy(np.array(want[name]))), name
        changed += int((got[name] != _torch(batch)[name]).sum())
    assert changed > 0  # some window of some entry was masked


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("m", [6, 12])
def test_spherical_fed_jax_draws_matches(m, k, lengths):
    batch = _sensor_batch(2 * m + k, m, LENGTHS[lengths])
    key = jax.random.PRNGKey(200 + m + k)
    want = JN.spherical_marker_noise_fn(0.7, 0.5, k)(_jax(batch), key)
    draws = _spherical_draws(key, N, F, m, k)
    got = TN.spherical_marker_noise(_torch(batch), draws, 0.7, 0.5)
    assert sorted(got) == sorted(want)
    for name in want:
        w = torch.from_numpy(np.array(want[name]))
        if name == "marker_pos":
            assert float((got[name] - w).abs().max()) <= SPHERICAL_TOL
            assert torch.equal(got[name] == _torch(batch)[name], w == _torch(batch)[name])
        else:
            assert torch.equal(got[name], w), name
    assert not torch.equal(got["marker_pos"], _torch(batch)["marker_pos"])


@pytest.mark.parametrize("case", ["strength_0", "no_marker_pos", "window_0"])
def test_spherical_early_exits_match_jax(case):
    """Strength 0, no ``marker_pos``, or ``int(ws * f) == 0``: the batch
    back unchanged from both packages, and no draw made by the port."""
    strength, length = {"strength_0": (0.0, 0.5), "window_0": (0.5, 0.05)}.get(case, (0.5, 0.5))
    batch = _sensor_batch(3, 12, LENGTHS["full"])
    if case == "no_marker_pos":
        del batch["marker_pos"]
    want = JN.spherical_marker_noise_fn(strength, length, 2)(_jax(batch), jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    tb = _torch(batch)
    got = TN.spherical_marker_noise_fn(strength, length, 2)(tb, g)
    assert got is tb and torch.equal(g.get_state(), state)
    for name in want:
        assert np.array_equal(got[name].numpy(), np.array(want[name])), name


def test_spherical_refuses_strength_without_length():
    for module in (JN, TN):
        with pytest.raises(ValueError, match="Temporal length"):
            module.spherical_marker_noise_fn(0.5, 0.0, 1)
    # Strength and length are clamped to [0, 1]: a negative length is 0.
    with pytest.raises(ValueError, match="Temporal length"):
        TN.spherical_marker_noise_fn(2.0, -1.0, 1)


def test_clamps_to_unit_interval_match_jax():
    """Strength and length above 1 act as 1 in both packages."""
    batch = _sensor_batch(8, 12, LENGTHS["ragged"])
    key = jax.random.PRNGKey(8)
    want = JN.spherical_marker_noise_fn(3.0, 7.0, 2)(_jax(batch), key)
    got = TN.spherical_marker_noise(_torch(batch), _spherical_draws(key, N, F, 12, 2),
                                    TN._clamp01(3.0), TN._clamp01(7.0))
    assert float((got["marker_pos"] - torch.from_numpy(np.array(want["marker_pos"])))
                 .abs().max()) <= SPHERICAL_TOL
    want = JN.marker_suppression_noise_fn(4.0, 2, 0.0, 12)(_jax(batch), key)
    got = TN.marker_suppression_noise(_torch(batch), *_suppression_draws(key, N, 2, 12),
                                      TN._clamp01(4.0), 0.0, 12)
    assert torch.equal(got["marker_ori"], torch.from_numpy(np.array(want["marker_ori"])))


BRANCHES = {
    "none": dict(),
    "spherical": dict(spherical_noise_strength=0.5, spherical_noise_length=0.5),
    "spherical_length_only": dict(spherical_noise_length=0.5),
    "suppression": dict(suppression_noise_length=0.5, noise_num_markers=2),
    "suppression_6": dict(suppression_noise_length=0.5, n_markers=6),
    "strength_only": dict(spherical_noise_strength=0.5),
}


@pytest.mark.parametrize("is_valid", [False, True])
@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_make_noise_fn_branch_table_matches_jax(branch, randomize, is_valid):
    """The same branch (the returned function's kind) in both packages, and
    the same output of a suppression branch on the same key."""
    cfg = BRANCHES[branch]
    want = JN.make_noise_fn(JConfiguration.from_dict(cfg), randomize, is_valid)
    got = TN.make_noise_fn(Configuration.from_dict(cfg), randomize, is_valid)
    assert got.__qualname__ == want.__qualname__


def test_make_noise_fn_refuses_both_types():
    cfg = dict(spherical_noise_length=0.5, suppression_noise_length=0.5)
    with pytest.raises(AssertionError):
        JN.make_noise_fn(JConfiguration.from_dict(cfg), True)
    with pytest.raises(ValueError, match="one noise type"):
        TN.make_noise_fn(Configuration.from_dict(cfg), True)
    with pytest.raises(ValueError, match="6 or 12"):
        TN.marker_suppression_noise_fn(0.5, 1, 0.0, 9)


def _se_ok(samples: torch.Tensor, mean: float, var: float) -> bool:
    return abs(float(samples.double().mean()) - mean) <= 5 * (var / samples.numel()) ** 0.5


def test_suppression_draws_by_moments():
    """4096 entries of 20 valid frames at length 0.25: window starts
    uniform on 0..15, each of the 6 candidates chosen with probability 1/6,
    the gate exactly 5 frames of the chosen markers."""
    n, f, k = 4096, 20, 2
    batch = {"marker_pos": torch.ones(n, f, 36), "marker_ori": torch.ones(n, f, 108),
             "marker_nor": torch.ones(n, f, 36), "seq_lengths": torch.full((n,), f)}
    g = torch.Generator().manual_seed(11)
    choice, u = TN.draw_suppression_noise(n, k, 6, g, "cpu")
    out = TN.marker_suppression_noise(batch, choice, u, 0.25, 0.0, 6)
    masked = out["marker_pos"].reshape(n, f, 12, 3)[..., 0] == 0  # (N, F, M)
    frames = masked.any(-1)
    starts = frames.float().argmax(1)
    assert (frames.sum(1) == 5).all()
    assert _se_ok(starts, 7.5, (16 ** 2 - 1) / 12)
    assert set(torch.nonzero(masked.any(1))[:, 1].tolist()) <= set(JC.S_CONFIG_6)
    for c in range(6):
        hits = (choice == c).double()
        assert _se_ok(hits, 1 / 6, (1 / 6) * (5 / 6))
    assert torch.equal(out["marker_ori"].reshape(n, f, 12, 9)[masked].unique(), torch.zeros(1))


def test_spherical_draws_by_moments():
    """4096 entries: the displacement's second moments are those of the
    quirked sphere (E r^2 = R^2/3; x^2 and y^2 carry 1/4, z^2 1/2), E z = 0,
    every component within R = max_r * thigh / 2; the window starts
    uniform; over 2000 draws each marker is among the K first of the
    permutation with probability K/M."""
    n, f, m, k, max_r = 4096, 20, 12, 3, 0.8
    pos = torch.zeros(n, f, m, 3)
    pos[0, f // 2, JC.T_TO_IDX_WO_ROOT[JC.T_RUL]] = torch.tensor([0.0, 2.0, 0.0])
    batch = {"marker_pos": pos.reshape(n, f, -1), "seq_lengths": torch.full((n,), f)}
    g = torch.Generator().manual_seed(12)
    draws = TN.draw_spherical_noise(n, f, m, k, g, "cpu")
    out = TN.spherical_marker_noise(batch, draws, max_r, 0.25)
    disp = (out["marker_pos"] - batch["marker_pos"]).reshape(n, f, m, 3)
    chosen = draws["perm"][:k]
    gate = (disp != 0).any(-1)
    assert set(torch.nonzero(gate.any((0, 1))).flatten().tolist()) <= set(chosen.tolist())
    frames = gate.any(-1)
    assert (frames.sum(1) == 5).all()
    assert _se_ok(frames.float().argmax(1), 7.5, (16 ** 2 - 1) / 12)
    big_r = max_r * 2.0 / 2
    d = disp[:, :, chosen][frames]  # (entries x 5 frames, K, 3)
    assert float(d.abs().max()) <= big_r
    for axis, factor in ((0, 0.25), (1, 0.25), (2, 0.5)):
        sq = d[..., axis].double() ** 2
        assert _se_ok(sq, big_r ** 2 / 3 * factor, float(sq.var()))
    assert _se_ok(d[..., 2], 0.0, float(d[..., 2].double().var()))
    firsts = torch.stack([TN.draw_spherical_noise(1, 1, m, k, g, "cpu")["perm"][:k]
                          for _ in range(2000)])
    for marker in range(m):
        hits = (firsts == marker).any(1).double()
        assert _se_ok(hits, k / m, (k / m) * (1 - k / m))


@pytest.mark.parametrize("kind", ["spherical", "suppression"])
def test_same_seed_same_output(kind):
    batch = _torch(_sensor_batch(4, 12, LENGTHS["ragged"]))
    fn = (TN.spherical_marker_noise_fn(0.5, 0.5, 2) if kind == "spherical"
          else TN.marker_suppression_noise_fn(0.5, 2, 0.0, 12))
    a, b, c = (fn(batch, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["marker_pos"], c["marker_pos"])


@pytest.mark.parametrize("branch", ["spherical", "suppression"])
def test_preprocess_applies_noise_after_the_offsets(row_major_sensors, offset_files,  # noqa: F811
                                                    branch):
    """``make_preprocess_fn`` with noise equals the clean preprocess
    followed by the noise function, drawing on from the same generator."""
    _, t_sensor = row_major_sensors
    base = dict(use_real_offsets=True, offset_noise_level=1, n_markers=12)
    cfg = dict(base, **BRANCHES[branch])
    bank = TT.OffsetBank.from_offset_files(offset_files)
    noisy = TT.make_preprocess_fn(t_sensor, bank, Configuration.from_dict(cfg), True)
    clean = TT.make_preprocess_fn(t_sensor, bank, Configuration.from_dict(base), True)
    batch = _torch(_batch(6))
    batch["seq_lengths"] = torch.tensor([5, 2, 0])
    got = noisy(batch, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    want = TN.make_noise_fn(Configuration.from_dict(cfg), True)(clean(batch, g), g)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    plain = clean(batch, torch.Generator().manual_seed(3))
    assert not torch.equal(got["marker_pos"], plain["marker_pos"])
