"""The port's streaming serving against the JAX package's, API and CLI.

LGD-RNN: tolerance atol 1e-4 (the LGD gradient input is scaled by n*f; see
test_torch_models.py). BiRNN: atol 5e-5 (no gradient input; see
test_torch_rnn_models.py); its JAX side runs the bidirectional layer kernel
in interpret mode at 17 streams.
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
from empose_tpu.nn import layers as JL
from empose_tpu.nn.models import create_model as j_create_model
from empose_tpu.serve import MultiStreamPredictor as JMultiStreamPredictor
from empose_tpu.serve import StreamingPredictor as JStreamingPredictor

from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.nn.models import create_model
from empose_tpu_torch.serve import MultiStreamPredictor, StreamingPredictor
from empose_tpu_torch.train.cli import main as train_main
from tests.test_torch_checkpoint import BASE, _jax_params, sensors  # noqa: F401 (fixture)

torch.set_num_threads(1)
ATOL = 1e-4
# The bf16 serving mode (--precision default) against the parity mode: bf16
# inputs in every NN and kinematics GEMM move the served angles by up to a
# few 1e-3 rad at these widths (tests/test_torch_precision.py).
DEFAULT_ATOL = 5e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(BASE, m_rnn_init=True, n_markers=12)
S, CHUNK = 4, 4


@pytest.fixture(scope="module")
def pair(sensors):
    j_sensor, t_sensor = sensors
    cfg, params, state = _jax_params(CFG, j_sensor, seed=21)
    t_model = create_model(Configuration.from_dict(CFG), t_sensor)
    t_model.load_state_dict(state_dict_from_jax(params, state, Configuration.from_dict(CFG)),
                            strict=True)
    return (j_create_model(cfg, j_sensor), params, state), t_model


def _feeds(seed, n_frames=12):
    rng = np.random.RandomState(seed)
    feeds = [((rng.randn(n_frames, 36) * 0.3).astype(np.float32),
              (rng.randn(n_frames, 108) * 0.3).astype(np.float32)) for _ in range(S)]
    offsets = [((rng.randn(12, 3) * 0.02).astype(np.float32),
                np.linalg.qr(rng.randn(12, 3, 3))[0].astype(np.float32)) for _ in range(S)]
    return feeds, offsets


def _assert_steps_equal(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for sid in want:
        assert sorted(got[sid]) == sorted(want[sid])
        for k in want[sid]:
            np.testing.assert_allclose(got[sid][k], want[sid][k], atol=atol,
                                       err_msg=f"stream {sid} {k}")


def test_multi_stream_matches_jax(pair):
    """4 streams: stream 3 idle until the last round, stream 1 flushed
    mid-chunk, stream 2 reset; every step equals the JAX predictor's."""
    (j_model, params, state), t_model = pair
    feeds, offsets = _feeds(0)
    port = MultiStreamPredictor(t_model, S, CHUNK)
    ref = JMultiStreamPredictor(j_model, params, state, S, CHUNK)
    for s in range(S):
        port.set_offsets(s, *offsets[s])
        ref.set_offsets(s, *offsets[s])
    for r in range(3):
        if r == 2:
            port.reset(2)
            ref.reset(2)
        for s in range(S):
            if s == 3 and r < 2:
                continue
            k = 2 if (s == 1 and r == 1) else CHUNK
            sl = slice(r * CHUNK, r * CHUNK + k)
            port.push(s, feeds[s][0][sl], feeds[s][1][sl])
            ref.push(s, feeds[s][0][sl], feeds[s][1][sl])
        flush = [1] if r == 1 else []
        got, want = port.step(flush_ids=flush), ref.step(flush_ids=flush)
        if r < 2:
            assert 3 not in got
        _assert_steps_equal(got, want)
    for h_t, h_j in zip(port.carry, ref.carry):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)


def test_streaming_predictor_matches_one_stream(pair):
    _, t_model = pair
    feeds, offsets = _feeds(1, n_frames=10)
    single = StreamingPredictor(t_model, CHUNK, offset_t=offsets[0][0], offset_r=offsets[0][1])
    multi = MultiStreamPredictor(t_model, S, CHUNK)
    for s in range(S):
        multi.set_offsets(s, *offsets[s])
        multi.push(s, *feeds[s])
    got = [single.push(*feeds[0]), single.flush()]
    want = multi.flush(range(S))[0]
    for k in want:
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]), want[k], atol=ATOL)
    assert got[0]["pose_body"].shape == (8, 63) and got[1]["pose_body"].shape == (2, 63)
    np.testing.assert_array_equal(got[1]["shape"][0], got[0]["shape"][0])  # frozen shape
    single.reset()
    assert single.flush() is None and single.carry is None


def _cli_input(rng):
    lines = []
    for t in range(6):
        for sid in (0, 1):
            lines.append({"stream": sid, "marker_pos": (rng.randn(36) * 0.3).tolist(),
                          "marker_ori": (rng.randn(108) * 0.3).tolist()})
        if t == 2:
            lines.append({"stream": 1, "cmd": "reset"})
    lines.append({"stream": 0, "cmd": "flush"})
    lines.append({"stream": 5, "marker_pos": [0.0] * 36, "marker_ori": [0.0] * 108})
    return "\n".join(json.dumps(l) for l in lines) + "\n"


def test_cli_matches_jax_cli(pair, assets_env, tmp_path, monkeypatch, capsys):
    """`python -m empose_tpu_torch.serve --device cpu --streams 2` and
    scripts/serve.py give the same JSON lines on the same model.pth."""
    (j_model, params, state), _ = pair
    exp = tmp_path / "710001-LGD-test"
    exp.mkdir()
    from empose_tpu.config import Configuration as JConfiguration
    JConfiguration.from_dict(CFG).to_json(str(exp / "config.json"))
    save_torch_checkpoint(str(exp / "model.pth"), params, state, JConfiguration.from_dict(CFG))
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    stdin = _cli_input(np.random.RandomState(5))

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "empose_tpu_torch.serve", "--model_id", "710001",
                          "--chunk", "3", "--streams", "2", "--device", "cpu"],
                         input=stdin, capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "dropping record with stream id 5" in res.stderr
    got = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]

    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    from scripts.serve import main as serve_main
    serve_main(argparse.Namespace(model_id="710001", chunk=3, streams=2, dp_devices=1,
                                  precision="highest"))
    want = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]

    assert [(r["stream"], r["frame"]) for r in got] == [(r["stream"], r["frame"]) for r in want]
    assert len(got) == 12
    for g, w in zip(got, want):
        for k in ("root_ori", "pose_body", "shape"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, err_msg=f"{g['stream']} {k}")

    # The bf16 serving mode runs through the same CLI: the same records,
    # within bf16's step of the parity mode (PERF.md, DEFAULT_ATOL).
    res = subprocess.run([sys.executable, "-m", "empose_tpu_torch.serve", "--model_id", "710001",
                          "--chunk", "3", "--streams", "2", "--device", "cpu", "--precision",
                          "default"],
                         input=stdin, capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    bf16 = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]
    assert [(r["stream"], r["frame"]) for r in bf16] == [(r["stream"], r["frame"]) for r in got]
    for g, w in zip(bf16, got):
        for k in ("root_ori", "pose_body", "shape"):
            np.testing.assert_allclose(g[k], w[k], atol=DEFAULT_ATOL, err_msg=f"{g['stream']} {k}")


BIRNN = dict(m_type="rnn", m_bidirectional=True, m_hidden_size=16, m_num_layers=2,
             m_estimate_shape=True, m_shape_hidden_size=8, m_average_shape=True,
             use_marker_pos=True, use_marker_ori=True, n_markers=6, window_size=8, lr=1e-3)
BIRNN_ATOL = 5e-5


@pytest.fixture(scope="module")
def birnn_pair(sensors):
    j_sensor, t_sensor = sensors
    cfg, params, state = _jax_params(BIRNN, j_sensor, seed=23)
    t_model = create_model(Configuration.from_dict(BIRNN), t_sensor)
    t_model.load_state_dict(state_dict_from_jax(params, state, Configuration.from_dict(BIRNN)),
                            strict=True)
    return (j_create_model(cfg, j_sensor), params, state), t_model


def test_birnn_multi_stream_matches_jax(birnn_pair, monkeypatch):
    """A BiRNN served to 17 streams x 3 chunks: stream 16 idle until the
    last chunk, stream 1 flushed mid-chunk, stream 2 reset before the last;
    every step and the carry (both directions' finals) equal the JAX
    predictor's, whose 17-row batch runs the bidirectional layer kernel."""
    monkeypatch.setattr(JL, "LSTM_KERNEL", "interpret")
    (j_model, params, state), t_model = birnn_pair
    n = 17
    rng = np.random.RandomState(7)
    pos = (rng.randn(n, 3 * CHUNK, 36) * 0.3).astype(np.float32)
    ori = (rng.randn(n, 3 * CHUNK, 108) * 0.3).astype(np.float32)
    port = MultiStreamPredictor(t_model, n, CHUNK)
    ref = JMultiStreamPredictor(j_model, params, state, n, CHUNK)
    for s in range(n):
        offsets = ((rng.randn(12, 3) * 0.02).astype(np.float32),
                   np.linalg.qr(rng.randn(12, 3, 3))[0].astype(np.float32))
        port.set_offsets(s, *offsets)
        ref.set_offsets(s, *offsets)
    for r in range(3):
        if r == 2:
            port.reset(2)
            ref.reset(2)
        for s in range(n):
            if s == n - 1 and r < 2:
                continue
            k = 2 if (s == 1 and r == 1) else CHUNK
            sl = slice(r * CHUNK, r * CHUNK + k)
            port.push(s, pos[s, sl], ori[s, sl])
            ref.push(s, pos[s, sl], ori[s, sl])
        flush = [1] if r == 1 else []
        got, want = port.step(flush_ids=flush), ref.step(flush_ids=flush)
        assert (n - 1 in got) == (r == 2)
        _assert_steps_equal(got, want, atol=BIRNN_ATOL)
    assert port.carry[0].shape == (4, n, 16)
    for c_t, c_j in zip(port.carry, ref.carry):
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=BIRNN_ATOL)


def test_birnn_streaming_session_matches_jax(birnn_pair):
    """One StreamingPredictor session (10 frames: two chunks and a flushed
    tail, then a reset and one more chunk) against the JAX predictor's."""
    (j_model, params, state), t_model = birnn_pair
    rng = np.random.RandomState(8)
    pos = (rng.randn(14, 36) * 0.3).astype(np.float32)
    ori = (rng.randn(14, 108) * 0.3).astype(np.float32)
    offset_t = (rng.randn(12, 3) * 0.02).astype(np.float32)
    offset_r = np.linalg.qr(rng.randn(12, 3, 3))[0].astype(np.float32)
    port = StreamingPredictor(t_model, CHUNK, offset_t=offset_t, offset_r=offset_r)
    ref = JStreamingPredictor(j_model, params, state, CHUNK, offset_t=offset_t, offset_r=offset_r)
    outs = []
    for p in (port, ref):
        got = [p.push(pos[:10], ori[:10]), p.flush()]
        p.reset()
        got.append(p.push(pos[10:], ori[10:]))
        outs.append(got)
    assert port.carry is not None and outs[0][1]["pose_body"].shape == (2, 63)
    for g, w in zip(*outs):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=BIRNN_ATOL, err_msg=k)


def test_birnn_cli_serves_port_trained_model(assets_env, tmp_path, monkeypatch, capsys):
    """A tiny BiRNN trained one step by the port's CLI writes model.pth and
    config.json; `python -m empose_tpu_torch.serve --device cpu` and
    scripts/serve.py give the same JSON lines on it."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    flags = ["--m_type", "rnn", "--m_bidirectional", "--m_hidden_size", "16", "--m_num_layers",
             "2", "--m_estimate_shape", "--m_shape_hidden_size", "8", "--m_average_shape",
             "--use_marker_pos", "--use_marker_ori", "--use_real_offsets", "--n_markers", "6",
             "--window_size", "16", "--bs_train", "2", "--eval_every", "1000000", "--seed", "5",
             "--experiment_id", "710002", "--max_steps", "1", "--device", "cpu"]
    model_dir, _ = train_main(flags)
    assert os.path.basename(model_dir).startswith("710002-BiRNN-16-16-shape8-avg-n6-")
    stdin = _cli_input(np.random.RandomState(6))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "empose_tpu_torch.serve", "--model_id", "710002",
                          "--chunk", "3", "--streams", "2", "--device", "cpu"],
                         input=stdin, capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    got = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]

    capsys.readouterr()
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    from scripts.serve import main as serve_main
    serve_main(argparse.Namespace(model_id="710002", chunk=3, streams=2, dp_devices=1,
                                  precision="highest"))
    want = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [(r["stream"], r["frame"]) for r in got] == [(r["stream"], r["frame"]) for r in want]
    assert len(got) == 12
    for g, w in zip(got, want):
        for k in ("root_ori", "pose_body", "shape"):
            np.testing.assert_allclose(g[k], w[k], atol=BIRNN_ATOL, err_msg=f"{g['stream']} {k}")
