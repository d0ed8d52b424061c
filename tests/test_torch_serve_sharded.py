"""Serving with the stream axis split over devices: the port's
``MultiStreamPredictor(mesh=...)`` and ``--dp_devices`` of its serve CLI
against the unsharded predictor and the JAX package's predictor on a
2-device mesh (``tests/conftest.py`` gives JAX 8 CPU devices).

Tolerance: the serve tests' ATOL 1e-4 (``tests/test_torch_serve.py``).
"""

import argparse
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from empose_tpu.checkpoint.torch_writer import save_torch_checkpoint
from empose_tpu.parallel.mesh import make_mesh as j_make_mesh
from empose_tpu.serve import MultiStreamPredictor as JMultiStreamPredictor

from empose_tpu_torch.serve import MultiStreamPredictor, main, parser
from tests.test_torch_checkpoint import sensors  # noqa: F401 (fixture)
from tests.test_torch_serve import ATOL, CFG, CHUNK, REPO, S, _assert_steps_equal, _cli_input
from tests.test_torch_serve import _feeds, pair  # noqa: F401 (fixture)

torch.set_num_threads(1)


def _serve(pred, feeds, offsets):
    """3 rounds over 4 streams: stream 3 (the second shard's) idle until the
    last round and reset before it, stream 1 flushed mid-chunk in round 1;
    then every stream drained."""
    for s in range(S):
        pred.set_offsets(s, *offsets[s])
    steps = []
    for r in range(3):
        if r == 2:
            pred.reset(3)
        for s in range(S):
            if s == 3 and r < 2:
                continue
            k = 2 if (s == 1 and r == 1) else CHUNK
            sl = slice(r * CHUNK, r * CHUNK + k)
            pred.push(s, feeds[s][0][sl], feeds[s][1][sl])
        steps.append(pred.step(flush_ids=[1] if r == 1 else []))
    for s in range(S):
        pred.push(s, feeds[s][0][-3:], feeds[s][1][-3:])
    steps.append(pred.flush(range(S)))
    return steps


def test_sharded_predictor_matches_unsharded_and_jax(pair):
    """Two shards on the CPU against one, and against the JAX predictor
    with the stream axis sharded over a 2-device mesh: every step's outputs
    and the final carry."""
    (j_model, params, state), t_model = pair
    feeds, offsets = _feeds(0)
    sharded = MultiStreamPredictor(t_model, S, CHUNK, mesh=["cpu", "cpu"])
    # Both shards on the model's own device: both run the model itself.
    assert len(sharded.replicas) == 2 and all(r is t_model for r in sharded.replicas)
    unsharded = MultiStreamPredictor(t_model, S, CHUNK)
    ref = JMultiStreamPredictor(j_model, params, state, S, CHUNK, mesh=j_make_mesh(2))
    got = _serve(sharded, feeds, offsets)
    whole = _serve(unsharded, feeds, offsets)
    want = _serve(ref, feeds, offsets)
    assert 3 not in got[0] and 3 in got[2]
    for g, u, w in zip(got, whole, want):
        _assert_steps_equal(g, u)
        _assert_steps_equal(g, w)
    assert sharded.carry[0].shape == (2, S, 32)
    for c_t, c_u, c_j in zip(sharded.carry, unsharded.carry, ref.carry):
        np.testing.assert_allclose(c_t.numpy(), c_u.numpy(), atol=ATOL)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL)


def test_reset_zeroes_its_shards_row(pair):
    """``reset(i)`` zeroes stream i's row of its own shard's carry and no
    other row."""
    _, t_model = pair
    feeds, offsets = _feeds(2)
    pred = MultiStreamPredictor(t_model, S, CHUNK, mesh=["cpu", "cpu"])
    for s in range(S):
        pred.push(s, feeds[s][0][:CHUNK], feeds[s][1][:CHUNK])
    pred.step()
    before = [c.clone() for c in pred.carry]
    pred.reset(3)
    after = pred.carry
    for b, a in zip(before, after):
        assert not a[:, 3].any() and b[:, 3].any()
        assert torch.equal(a[:, :3], b[:, :3])


def test_indivisible_stream_count_raises(pair):
    (j_model, params, state), t_model = pair
    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        MultiStreamPredictor(t_model, 3, CHUNK, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        JMultiStreamPredictor(j_model, params, state, 3, CHUNK, mesh=j_make_mesh(2))


def test_cli_refuses_dp_devices_with_one_stream():
    """``--dp_devices 2`` without ``--streams`` > 1 exits with the JAX CLI's
    message."""
    with pytest.raises(SystemExit) as got:
        main(parser().parse_args(["--model_id", "1", "--dp_devices", "2", "--device", "cpu"]))
    from scripts.serve import main as j_main
    with pytest.raises(SystemExit) as want:
        j_main(argparse.Namespace(model_id="1", chunk=16, streams=1, dp_devices=2,
                                  precision="highest"))
    assert str(got.value) == str(want.value) and "--streams > 1" in str(got.value)


def test_cli_dp_devices_matches_jax_cli(pair, assets_env, tmp_path, monkeypatch, capsys):
    """``python -m empose_tpu_torch.serve --streams 2 --dp_devices 2 --device
    cpu`` gives the records of ``scripts/serve.py --dp_devices 2`` on the
    same model.pth."""
    (j_model, params, state), _ = pair
    exp = tmp_path / "710002-LGD-test"
    exp.mkdir()
    from empose_tpu.config import Configuration as JConfiguration
    JConfiguration.from_dict(CFG).to_json(str(exp / "config.json"))
    save_torch_checkpoint(str(exp / "model.pth"), params, state, JConfiguration.from_dict(CFG))
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    stdin = _cli_input(np.random.RandomState(6))

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "empose_tpu_torch.serve", "--model_id", "710002",
                          "--chunk", "3", "--streams", "2", "--dp_devices", "2", "--device",
                          "cpu"], input=stdin, capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    got = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]

    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    from scripts.serve import main as serve_main
    serve_main(argparse.Namespace(model_id="710002", chunk=3, streams=2, dp_devices=2,
                                  precision="highest"))
    want = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [(r["stream"], r["frame"]) for r in got] == [(r["stream"], r["frame"]) for r in want]
    assert len(got) == 12
    for g, w in zip(got, want):
        for k in ("root_ori", "pose_body", "shape"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, err_msg=f"{g['stream']} {k}")
