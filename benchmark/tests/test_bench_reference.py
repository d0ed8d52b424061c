"""The plain reference against the program at tiny widths on the CPU."""

import os

import numpy as np
import pytest
import torch

from benchmark import assets as A
from benchmark.reference import body as B
from benchmark.reference import nn as R
from benchmark.tests.tiny import TINY_FLAGS, load, run_cell, tiny_root
from benchmark.tests.conftest import ROOT


@pytest.fixture(scope="module")
def npz():
    return A.smplh_npz(A.rng_of(7, 0))


def test_fk_and_sensors_match_the_program(npz, tmp_path):
    from empose_tpu_torch.bodymodel.smplh import load_smplh
    from empose_tpu_torch.nn.models import SensorSMPL

    path = os.path.join(tmp_path, "model.npz")
    np.savez(path, **npz)
    sensor = SensorSMPL(load_smplh(path))
    rng = np.random.default_rng(1)
    poses = torch.tensor(rng.standard_normal((40, 66)) * 0.5, dtype=torch.float32)
    betas = torch.tensor(rng.standard_normal((40, 10)), dtype=torch.float32)
    trans = torch.tensor(rng.standard_normal((40, 3)) * 0.1, dtype=torch.float32)
    pos, ori, _, joints = sensor.markers_and_joints(poses, betas, trans)
    body = B.sensor_body(npz)
    verts, j_ref = B.fk(body, poses, betas, trans)
    p_ref, o_ref = B.sensors(body, verts)
    assert (pos - p_ref).abs().max() < 1e-5
    assert (ori - o_ref).abs().max() < 1e-4
    assert (joints - j_ref).abs().max() < 1e-5


def test_library_lstm_equals_the_step_loop():
    spec = R.lstm_spec("rnn.lstm", 7, 5, 2, True)
    g = torch.Generator().manual_seed(0)
    p = {k: torch.rand(s, generator=g) - 0.5 for k, s, _ in spec}
    x = torch.randn(3, 9, 7, generator=g)
    lengths = torch.full((3,), 9)
    a = R.lstm(p, "rnn.lstm", x, lengths, 2, True)
    b = R.lstm(p, "rnn.lstm", x, lengths, 2, True, library=True)
    for u, v in ((a[0], b[0]), (a[1][0], b[1][0]), (a[1][1], b[1][1])):
        assert (u - v).abs().max() < 1e-6


@pytest.mark.parametrize("config", ["lgd_rnn6", "birnn6"])
def test_eval_forward_with_carry_matches_the_program(config, npz, tmp_path):
    from empose_tpu_torch.bodymodel.smplh import load_smplh
    from empose_tpu_torch.config import Configuration
    from empose_tpu_torch.nn.models import SensorSMPL, create_model
    import importlib

    cfg = load(os.path.join(ROOT, "benchmark", "configs", config + ".json"))
    flags = dict(cfg["flags"], **TINY_FLAGS)
    mod = importlib.import_module(cfg["reference"][:-3].replace("/", "."))
    weights = A.make_weights(mod.spec(flags), 3, "cpu")
    path = os.path.join(tmp_path, "model.npz")
    np.savez(path, **npz)
    model = create_model(Configuration.from_dict(flags), SensorSMPL(load_smplh(path)))
    model.load_state_dict(weights, strict=True)
    model.eval()
    body = B.sensor_body(npz)
    rng = np.random.default_rng(2)
    carry = state = None
    for _ in range(3):
        window = {"marker_pos": torch.tensor(rng.standard_normal((4, 8, 36)) * 0.3, dtype=torch.float32),
                  "marker_ori": torch.tensor(rng.standard_normal((4, 8, 108)), dtype=torch.float32),
                  "seq_lengths": torch.full((4,), 8), "offset_t": torch.zeros(4, 12, 3),
                  "offset_r": torch.eye(3).expand(4, 12, 3, 3)}
        with torch.no_grad():
            got, carry = model(window, carry)
            want, state = mod.forward(weights, body, window, flags, train=False, state=state)
        assert (got["pose_hat"] - want["pose"][..., 3:]).abs().max() < 1e-4
        assert (got["root_ori_hat"] - want["pose"][..., :3]).abs().max() < 1e-4
        if "shape" in want:
            assert (got["shape_hat"] - want["shape"]).abs().max() < 1e-4
        assert (carry[0] - state[0]).abs().max() < 1e-5


@pytest.mark.parametrize("cell", ["lgd_rnn6.train.b64w256", "birnn6.train.b64w256"])
def test_train_steps_match_the_program(cell, tmp_path):
    res = run_cell(tiny_root(tmp_path), cell)
    gaps = {k: v["value"] for k, v in res["compared"].items()}
    assert res["correct"] and gaps["loss_gap_1"] < 1e-5 and gaps["grad_norm_gap"] < 1e-4, gaps
