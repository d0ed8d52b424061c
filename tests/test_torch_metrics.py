"""The port's metric engine (``empose_tpu_torch/eval/metrics.py``) against
the JAX package's: each metric function, the sufficient statistics against
both packages' ``MetricsEngine``, the per-sample mode, empty and degenerate
inputs, and the batched Procrustes against the SVD oracle on exactly
symmetric point sets.

Inputs are made from a numpy seed and given to both sides; the body model
is the synthetic SMPL-H (seed 0) as a JAX and a port model from the same
arrays. Tolerances: rtol 1e-5 for each metric function, fp32 on both sides
in another summation order, with atol 1e-5 in the functions' own units, but
1e-3 degrees for the geodesic angles (an fp32 arccos near +-1 loses
digits); local rotations at human-like scales (0.25 rad per dof), since the
log map is ill-conditioned in fp32 near pi; rtol 1e-4 for metrics
aggregated from fp32 sums of many frames; Procrustes residual below 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empose_tpu import constants as JC
from empose_tpu.eval import metrics as JM
from empose_tpu.ops import quaternions as JQ
from empose_tpu.ops import so3 as JS

from empose_tpu_torch.eval import metrics as M
from empose_tpu_torch.ops import quaternions as Q
from empose_tpu_torch.ops import so3 as S
from tests.test_torch_checkpoint import synthetic_models

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_DEG = dict(rtol=1e-5, atol=1e-3)
TOL_AGG = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    j_model, t_model = synthetic_models()
    return j_model, t_model


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _poses(rng, rows, scale=0.25):
    return (rng.randn(rows, 63) * scale).astype(np.float32)


def _point_sets(rng, rows, j=22):
    x = rng.randn(rows, j, 3).astype(np.float32)
    # Y: a rotated, scaled, shifted and perturbed copy of X, some reflected.
    q = rng.randn(rows, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, a, b, c = q.T
    R = np.stack([np.stack([1 - 2 * (b * b + c * c), 2 * (a * b - w * c), 2 * (a * c + w * b)], -1),
                  np.stack([2 * (a * b + w * c), 1 - 2 * (a * a + c * c), 2 * (b * c - w * a)], -1),
                  np.stack([2 * (a * c - w * b), 2 * (b * c + w * a), 1 - 2 * (a * a + b * b)], -1)],
                 -2)
    R[::3, :, 0] *= -1
    y = np.einsum("rab,rjb->rja", R, x) * rng.uniform(0.5, 2.0, (rows, 1, 1)) + rng.randn(rows, 1, 3)
    return x, (y + rng.randn(*y.shape) * 0.05).astype(np.float32)


FUNCS = {
    "rotation_intrinsic_distance_from_aa": lambda rng: (
        (rng.randn(64, 3), rng.randn(64, 3)),
        JQ.rotation_intrinsic_distance_from_aa, Q.rotation_intrinsic_distance_from_aa),
    "so3_relative_angle": lambda rng: (
        tuple(np.asarray(JS.so3_exponential_map(jnp.asarray(rng.randn(64, 3), jnp.float32)))
              for _ in range(2)),
        JS.so3_relative_angle, S.so3_relative_angle),
    "local_to_global_aa": lambda rng: (
        (_poses(rng, 32),),
        lambda p: JS.local_to_global(p, JC.SMPL_PARENTS[:21]),
        lambda p: S.local_to_global(p, JC.SMPL_PARENTS[:21])),
    "local_to_global_rotmat": lambda rng: (
        (_poses(rng, 32),),
        lambda p: JS.local_to_global(p, JC.SMPL_PARENTS[:21], output_format="rotmat"),
        lambda p: S.local_to_global(p, JC.SMPL_PARENTS[:21], output_format="rotmat")),
    "procrustes_align": lambda rng: (
        _point_sets(rng, 16), jax.vmap(JM.procrustes_align), M.procrustes_align),
    "procrustes_align_batched": lambda rng: (
        _point_sets(rng, 64), JM.procrustes_align_batched, M.procrustes_align_batched),
    "eucl_dists": lambda rng: (
        _point_sets(rng, 64), JM._eucl_dists, M._eucl_dists),
    "angle_dists": lambda rng: (
        (_poses(rng, 64), _poses(rng, 64)),
        lambda a, b: JM._angle_dists(a, b, JC.SMPL_PARENTS), M._angle_dists),
    "raw_aa_angles": lambda rng: (
        (_poses(rng, 64), _poses(rng, 64)), JM._raw_aa_angles, M._raw_aa_angles),
    "rotmat_angles": lambda rng: (
        tuple(np.asarray(JS.so3_exponential_map(jnp.asarray(rng.randn(64, 5, 3), jnp.float32))
                         ).reshape(64, -1) for _ in range(2)),
        JM._rotmat_angles, M._rotmat_angles),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_metric_function_matches_jax(name):
    args, jax_fn, port_fn = FUNCS[name](np.random.RandomState(sorted(FUNCS).index(name)))
    args = tuple(np.asarray(a, np.float32) for a in args)
    want = jax_fn(*(jnp.asarray(a) for a in args))
    got = port_fn(*(_t(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    tol = TOL_DEG if "angle" in name else TOL
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), **tol, err_msg=name)


def _window(rng, n=3, f=12, m=12, root=True):
    """One (N, F) eval window with ragged lengths, a 0-length row, masked
    marker-frames, per-sequence predicted betas."""
    lengths = np.array([f, f - 5, 0][:n] + [f] * max(0, n - 3), np.int32)
    masks = np.ones((n, f, m), np.float32)
    masks[0, 2:4, 3] = 0.0
    w = dict(pose=(rng.randn(n, f, 63) * 0.3).astype(np.float32),
             shape=(rng.randn(n, 10) * 0.5).astype(np.float32),
             pose_hat=(rng.randn(n, f, 63) * 0.3).astype(np.float32),
             shape_hat=(rng.randn(n, 10) * 0.5).astype(np.float32),
             seq_lengths=lengths, frame_mask=masks)
    if root:
        w["pose_root"] = (rng.randn(n, f, 3) * 0.5).astype(np.float32)
        w["pose_root_hat"] = (rng.randn(n, f, 3) * 0.5).astype(np.float32)
    return w


def _port_stats(t_model, windows, per_sample=False):
    body = M.body_model(t_model, "cpu")
    n = windows[0]["pose"].shape[0]
    stats = M.metric_stats_init(n if per_sample else None)
    for w in windows:
        tw = {k: (torch.from_numpy(v.astype(np.int64)) if k == "seq_lengths" else _t(v))
              for k, v in w.items()}
        stats = M.metric_stats_update(body, stats, **tw, per_sample=per_sample)
    return M.stats_to_host(stats)


_jax_update = jax.jit(JM.metric_stats_update, static_argnames=("per_sample",))


def _jax_stats(j_model, windows, per_sample=False):
    n = windows[0]["pose"].shape[0]
    stats = JM.metric_stats_init(n if per_sample else None)
    for w in windows:
        stats = _jax_update(j_model, stats, **{k: jnp.asarray(v) for k, v in w.items()},
                            per_sample=per_sample)
    return jax.device_get(stats)


@pytest.mark.parametrize("shape_mode", ["per_sequence", "per_frame", "ground_truth"])
def test_stats_match_both_engines(models, shape_mode):
    """Statistics over two windows -> metrics equal the port's host
    MetricsEngine, the JAX package's (per-sequence shapes) and the JAX
    statistics; the raw sums equal JAX's."""
    j_model, t_model = models
    rng = np.random.RandomState(3)
    windows = [_window(rng), _window(rng)]
    for w in windows:
        if shape_mode == "per_frame":
            w["shape_hat"] = (rng.randn(3, 12, 10) * 0.5).astype(np.float32)
        elif shape_mode == "ground_truth":
            w["shape_hat"] = None
    windows = [{k: v for k, v in w.items() if v is not None} for w in windows]
    got_stats = _port_stats(t_model, windows)
    want_stats = _jax_stats(j_model, windows)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], np.asarray(want_stats[k]), rtol=1e-5, atol=1e-3,
                                   err_msg=k)
    engines = {"port engine": M.MetricsEngine(t_model, "cpu")}
    if shape_mode == "per_sequence":  # the JAX engine compiles per instance: once here
        engines["JAX engine"] = JM.MetricsEngine(j_model)
    for w in windows:
        for me in engines.values():
            me.compute(**w)
    got = M.metrics_from_stats(got_stats)
    wants = {name: me.get_metrics() for name, me in engines.items()}
    wants["JAX stats"] = JM.metrics_from_stats(want_stats)
    for name, want in wants.items():
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()), **TOL_AGG,
                                   err_msg=name)


def test_per_sample_stats(models):
    """Per-sequence statistics: each row equals that sequence's own
    aggregate, the reduced rows the pass aggregate, and JAX's per-sample
    statistics."""
    j_model, t_model = models
    rng = np.random.RandomState(5)
    windows = [_window(rng, n=4), _window(rng, n=4)]
    rows = _port_stats(t_model, windows, per_sample=True)
    np.testing.assert_allclose(rows["n"], [20, 14, 0, 24])  # row 0: 2 masked frames per window
    want = _jax_stats(j_model, windows, per_sample=True)
    for k in want:
        np.testing.assert_allclose(rows[k], np.asarray(want[k]), rtol=1e-5, atol=1e-3, err_msg=k)
    for i in range(4):
        alone = _port_stats(t_model, [{k: v[i:i + 1] for k, v in w.items()} for w in windows])
        got = M.metric_stats_select(rows, i)
        for k in alone:
            np.testing.assert_allclose(got[k], alone[k].reshape(got[k].shape), rtol=1e-6,
                                       atol=1e-6, err_msg=f"row {i} {k}")
    total = M.metrics_from_stats(M.metric_stats_reduce(rows))
    whole = M.metrics_from_stats(_port_stats(t_model, windows))
    np.testing.assert_allclose(list(total.values()), list(whole.values()), rtol=1e-6)
    merged = M.metric_stats_merge(M.metric_stats_select(rows, 0), M.metric_stats_select(rows, 1))
    assert merged["eucl_sum"].dtype == np.float64


def test_empty_and_degenerate_inputs(models):
    """No valid frame: zeros from both aggregations, nothing recorded.
    Perfect predictions: zero position errors. All points equal: finite
    Procrustes. Refusals raise ValueError."""
    _, t_model = models
    rng = np.random.RandomState(7)
    w = _window(rng)
    w["seq_lengths"] = np.zeros(3, np.int32)
    zeros = dict.fromkeys(M.METRIC_NAMES, 0.0)
    assert M.metrics_from_stats(_port_stats(t_model, [w])) == zeros
    me = M.MetricsEngine(t_model, "cpu")
    me.compute(**w)
    assert me.eucl_dists == [] and me.get_metrics() == zeros
    me.compute_joint_dist(rng.randn(3, 12, 66), rng.randn(3, 12, 66), seq_lengths=w["seq_lengths"])
    me.compute_angle_dist(rng.randn(3, 12, 63), rng.randn(3, 12, 63), seq_lengths=w["seq_lengths"])
    assert me.get_metrics() == zeros

    w = _window(rng)
    w.update(pose_hat=w["pose"], shape_hat=None, pose_root_hat=w["pose_root"])
    w = {k: v for k, v in w.items() if v is not None}
    m = M.metrics_from_stats(_port_stats(t_model, [w]))
    assert m["MPJPE [mm]"] == 0.0 and m["PA-MPJPE [mm]"] < 1e-3

    same = torch.ones(4, 22, 3)
    assert torch.isfinite(M.procrustes_align_batched(same, same)).all()
    assert torch.isfinite(M.procrustes_align(same, same)).all()

    with pytest.raises(ValueError, match="rep"):
        me.compute_angle_dist(w["pose"], w["pose_hat"], rep="quat")
    me.set_stats(_port_stats(t_model, [w]))
    with pytest.raises(ValueError, match="statistics"):
        me.get_metrics(eucl_idxs_select=False)
    me.reset()
    assert me.get_metrics() == zeros


def _rot_z90(x):
    return np.stack([-x[..., 1], x[..., 0], x[..., 2]], -1)


@pytest.mark.parametrize("points", ["axis", "cube"])
def test_batched_procrustes_on_symmetric_sets(points):
    """An exactly symmetric set rotated 90 degrees about z: the batched
    (Horn) alignment recovers it like the SVD oracle, residual < 1e-4 (the
    JAX package's Horn path leaves it unaligned, ROADMAP.md)."""
    if points == "axis":
        x = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    else:
        x = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)], np.float32)
    X, Y = _t(x)[None], _t(_rot_z90(x))[None]
    oracle = M.procrustes_align(X, Y)
    batched = M.procrustes_align_batched(X, Y)
    assert float((oracle - X).abs().max()) < 1e-4
    assert float((batched - X).abs().max()) < 1e-4
    assert float((batched - oracle).abs().max()) < 1e-4


def test_metric_table_format():
    s = M.format_table(["Nr", "E2E 1"] + list(M.METRIC_NAMES),
                       [[0, "seq0"] + [1.5] * 6, [1, "Overall average"] + [175.96763] * 6])
    lines = s.splitlines()
    assert lines[0].split() == ["Nr", "E2E", "1", "MPJPE", "[mm]", "MPJPE", "STD", "PA-MPJPE",
                                "[mm]", "PA-MPJPE", "STD", "MPJAE", "[deg]", "MPJAE", "STD"]
    assert set(lines[1].replace(" ", "")) == {"-"}
    assert lines[3].split()[:3] == ["1", "Overall", "average"] and "175.968" in lines[3]
    assert "Model" in M.MetricsEngine.to_pretty_string(dict.fromkeys(M.METRIC_NAMES, 1.0), "VALID")
