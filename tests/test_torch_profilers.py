"""The step profilers and ``measure_remat`` (``empose_tpu_torch/tools/``).

``profile_fk``'s parts against the expressions the JAX ``tools/profile_fk.py``
times, on the same inputs at 64 rows (rodrigues, the rigid chain, the
blendshapes + LBS, the sensor frames, the offset apply: within 1e-5), and
composed, against ``SensorSMPL.estimated_markers`` bit for bit.
``profile_backward``'s FK scalar against the JAX lane FK's (relative 1e-5).
Each tool's ``main`` at a tiny config on the CPU (one iteration): its rows
carry the JAX tool's names; without CUDA and without ``--device cpu`` each
raises.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from empose_tpu.bodymodel import smplh as JS
from empose_tpu.data import virtual_sensors as jvsens
from empose_tpu.nn.models import SensorSMPL as JSensorSMPL

from empose_tpu_torch.data import virtual_sensors as vsens
from empose_tpu_torch.nn.models import SensorSMPL
from empose_tpu_torch.tools import (measure_remat, profile_backward, profile_common, profile_fk,
                                    profile_forward, profile_train)
from tests.test_torch_checkpoint import synthetic_models

torch.set_num_threads(1)
ROWS = 64
HI = lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def fk_setup():
    j_model, t_model = synthetic_models()
    j_sensor, t_sensor = JSensorSMPL(j_model), SensorSMPL(t_model)
    x = profile_fk.inputs(np.random.RandomState(2), ROWS, "cpu")
    return j_sensor, t_sensor, {k: v.numpy() for k, v in x.items()}


def _jax_blend_lbs(sub, rm, sh, Rg, ts):
    """The JAX tool's blendshapes + LBS (``tools/profile_fk.py``)."""
    n = rm.shape[0]
    v_rest = sub.v_template[None] + jnp.einsum("vdb,nb->nvd", sub.shapedirs, sh, precision=HI)
    pose_feature = (rm[:, 1:] - jnp.eye(3, dtype=jnp.float32)).reshape(n, -1)
    v_posed = v_rest + jnp.matmul(pose_feature, sub.posedirs, precision=HI).reshape(n, -1, 3)
    Rw = jnp.einsum("vj,njab->nvab", sub.weights, Rg, precision=HI)
    tw = jnp.einsum("vj,nja->nva", sub.weights, ts, precision=HI)
    return jnp.einsum("nvab,nvb->nva", Rw, v_posed, precision=HI) + tw


def _jax_parts(j_sensor, x):
    """Each part of the JAX tool: (its inputs, its outputs), chained from x."""
    sub = j_sensor.sub
    full_pose = jnp.concatenate(
        [x["pose"], jnp.zeros((ROWS, (sub.n_joints - 22) * 3), jnp.float32)], -1)
    rm = JS.rodrigues(full_pose.reshape(ROWS, sub.n_joints, 3))
    j_rest = sub.j_template[None] + jnp.einsum("jdb,nb->njd", sub.j_shapedirs, x["shape"])
    chain = JS._rigid_transform_chain(rm, j_rest, sub.parents)
    verts = _jax_blend_lbs(sub, rm, x["shape"], chain[1], chain[2])
    pos, ori, _ = jvsens.virtual_pos_and_rot(verts, j_sensor.tables)
    oc = jnp.matmul(ori, x["offset_r"], precision=HI)
    pc = pos + jnp.squeeze(jnp.matmul(ori, x["offset_t"][..., None], precision=HI), -1)
    return {"rodrigues": ((x["pose"],), (rm,)),
            "rigid chain": ((rm, j_rest), chain),
            "blendshapes + LBS": ((rm, x["shape"], chain[1], chain[2]), (verts,)),
            "sensor frames": ((verts,), (pos, ori)),
            "offset apply": ((pos, ori, x["offset_r"], x["offset_t"]), (pc, oc))}


@pytest.mark.parametrize("part", profile_fk.PARTS)
def test_fk_part_matches_the_jax_tool(fk_setup, part):
    j_sensor, t_sensor, x = fk_setup
    sub, tables = t_sensor._sub_model(), t_sensor._tables()
    args, want = _jax_parts(j_sensor, x)[part]
    args = [torch.from_numpy(np.array(a)) for a in args]
    got = {"rodrigues": lambda a: (profile_fk.rodrigues_part(sub, *a),),
           "rigid chain": lambda a: profile_fk.chain_part(sub, *a),
           "blendshapes + LBS": lambda a: (profile_fk.blend_lbs_part(sub, *a),),
           "sensor frames": lambda a: vsens.virtual_pos_and_rot(*a, tables)[:2],
           "offset apply": lambda a: profile_fk.offset_part(*a)}[part](args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=part)


def test_fk_parts_compose_to_estimated_markers(fk_setup):
    _, sensor, x = fk_setup
    sub, tables = sensor._sub_model(), sensor._tables()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    rot = profile_fk.rodrigues_part(sub, t["pose"])
    _, R_glob, t_skin = profile_fk.chain_part(sub, rot, profile_fk.rest_joints(sub, t["shape"]))
    verts = profile_fk.blend_lbs_part(sub, rot, t["shape"], R_glob, t_skin)
    pos, ori, _ = vsens.virtual_pos_and_rot(verts, tables)
    mp, mo = profile_fk.offset_part(pos, ori, t["offset_r"], t["offset_t"])
    want = sensor.estimated_markers(t["pose"], t["shape"], t["offset_r"], t["offset_t"])
    assert torch.equal(mp, want[0]) and torch.equal(mo, want[1])


def test_backward_fk_scalar_matches_the_lane_fk(fk_setup):
    j_sensor, t_sensor, x = fk_setup
    orr_l, ott_l = j_sensor.lane_fk.prepare_offsets(jnp.asarray(x["offset_r"]),
                                                    jnp.asarray(x["offset_t"]))
    mp, mo, j = j_sensor.lane_fk(jnp.asarray(x["pose"]), jnp.asarray(x["shape"]), orr_l, ott_l)
    want = float(jnp.sum(mp * mp) + jnp.sum(mo) + jnp.sum(j * j))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = float(profile_backward.fk_scalar(t_sensor, t["pose"], t["shape"], t["offset_r"],
                                           t["offset_t"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _tiny_rnn(config):
    """Narrow the init RNN and the iter MLPs of ``config`` to test widths."""
    config.m_hidden_size, config.m_num_layers = 16, 1
    config.m_rnn_hidden_size, config.m_rnn_num_layers = 16, 1
    return config


TINY = dict(config=profile_common.flagship_config(tiny=True), warmup=0, repeats=1)
TINY_RUNS = {
    "profile_fk": (profile_fk, ["--rows", "16"], dict(iters=1, warmup=0)),
    "profile_forward": (profile_forward, ["--batch", "2", "--window", "8"],
                        dict(config=_tiny_rnn(profile_common.bench_config()), iters=1,
                             warmup=0)),
    "profile_train": (profile_train, ["--batch", "2", "--window", "8", "--remat"],
                      dict(TINY, iters=1)),
    "profile_backward": (profile_backward, ["--batch", "2", "--window", "8", "--precision",
                                            "default"], dict(TINY, iters=1)),
    "measure_remat": (measure_remat, ["--regimes", "2x8", "--iters", "1"], TINY),
}
JAX_ROWS = {
    "profile_fk": ["estimated_markers (all)", "rodrigues", "rigid chain", "blendshapes + LBS",
                   "sensor frames", "offset apply"],
    "profile_forward": ["full forward", "init RNN + heads", "FK+sensor (1 eval)",
                        "recon val+grad", "iter-MLP pair", "iter-MLP unfused", "sum of parts"],
    "profile_train": ["datagen (preprocess chain)", "forward + loss",
                      "forward + backward (grad)", "adam update", "FULL fused step",
                      "sum of isolated stages"],
    "profile_backward": ["lane FK+sensors fwd (x1)", "lane FK+sensors fwd+grad (x1)",
                         "init LSTM fwd", "init LSTM fwd+grad", "iter MLP pair fwd (x1)",
                         "iter MLP pair fwd+grad (x1)", "FULL model fwd+loss",
                         "FULL model fwd+grad"],
}


@pytest.mark.parametrize("tool", sorted(TINY_RUNS))
def test_tool_runs_on_the_cpu_with_the_jax_rows(tool, capsys):
    module, argv, kw = TINY_RUNS[tool]
    rows = module.main(argv + ["--device", "cpu"], **kw)
    out = capsys.readouterr().out
    if tool == "measure_remat":
        assert [(r["bs"], r["window"], r["remat"]) for r in rows] == [(2, 8, False), (2, 8, True)]
        jax_keys = {"bs", "window", "remat", "precision", "step_ms", "memory"}
        last = json.loads(out.strip().splitlines()[-1])
        assert last == rows
        for r in rows:
            assert jax_keys <= set(r) and r["memory"] is None and r["step_ms"] > 0
            assert r["steps"] == 0 + 1 + 1 * 1  # warm, counted, timed
            assert r["flops_per_frame"] > 0  # the timing guard had its floor
        return
    assert sorted(rows) == sorted(JAX_ROWS[tool])
    assert "on cpu" in out.splitlines()[0]
    for name, row in rows.items():
        assert row["ms"] is None or row["ms"] > 0, name
    if tool == "profile_backward":
        assert all(rows[name]["gflop"] > 0 for name in JAX_ROWS[tool]), rows


@pytest.mark.parametrize("tool", sorted(TINY_RUNS))
def test_tool_without_cuda_raises(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    module, argv, kw = TINY_RUNS[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv, **kw)
