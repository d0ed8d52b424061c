"""The port's eval CLI (``python -m empose_tpu_torch.eval``) against
``scripts/evaluate_real.py`` (ResNet and BiRNN here; the LGD families in
``tests/test_torch_eval_cli_lgd.py``), and training through an eval
boundary.

For each family of the eight released variants
(``tests/test_released_configs.py``: ResNet, BiRNN, LGD without and with
the init RNN, each at 6 and 12 sensors) at narrow widths (hidden 32), JAX
``model.init`` weights are written as a reference-layout ``model.pth``
(``save_torch_checkpoint``) that both CLIs load, so the weights cross over
as ``checkpoint/from_jax`` maps them. The asset tree is ``tests/conftest.py``'s.
The rows compare by id exactly and by number at rtol 1e-4 (atol 1e-3 in
the rows' units: the JAX table prints 6 significant digits), with each of the
port's three passes against the JAX CLI's default pass.
"""

import argparse
import os
import re

import numpy as np
import pytest
import torch

from empose_tpu.bodymodel.smplh import load_smplh as j_load_smplh
from empose_tpu.checkpoint.torch_writer import save_torch_checkpoint
from empose_tpu.nn.models import SensorSMPL as JSensorSMPL
from scripts.evaluate_real import main as jax_eval_main

from empose_tpu_torch.eval import cli
from empose_tpu_torch.eval.metrics import METRIC_NAMES
from empose_tpu_torch.train.cli import main as train_main
from tests.test_released_configs import RELEASED_VARIANTS
from tests.test_torch_checkpoint import _jax_params
from tests.test_torch_train_loop import TINY_LGD

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-3)


def variant_config(kind: str, n_markers: int) -> dict:
    """The released architecture of ``kind`` at narrow widths."""
    cfg = dict(use_marker_pos=True, use_marker_ori=True, use_real_offsets=True,
               offset_noise_level=0, n_markers=n_markers, window_size=16, lr=5e-4)
    if kind == "resnet":
        cfg.update(m_type="resnet", m_hidden_size=32, m_num_layers=2, m_estimate_shape=True,
                   m_shape_hidden_size=16, m_average_shape=True)
    elif kind == "rnn":
        cfg.update(m_type="rnn", m_bidirectional=True, m_hidden_size=32, m_num_layers=2,
                   m_estimate_shape=True, m_shape_hidden_size=16, m_average_shape=True)
    elif kind == "lgd_nornn":
        cfg.update(m_type="lgd", m_hidden_size=32, m_num_layers=2, m_num_iterations=2,
                   m_use_gradient=True, m_average_shape=True, m_reprojection_loss_weight=0.01,
                   m_fk_loss=0.1)
    else:
        cfg.update(m_type="ief", m_hidden_size=32, m_num_layers=2, m_num_iterations=2,
                   m_use_gradient=True, m_average_shape=True, m_rnn_init=True,
                   m_rnn_hidden_size=32, m_reprojection_loss_weight=0.01, m_fk_loss=0.1,
                   m_pose_loss_weight=10.0)
    return cfg


def write_experiment(exp_dir: str, model_id: str, cfg_dict: dict, seed: int) -> None:
    j_cfg, params, state = _jax_params(cfg_dict, JSensorSMPL(j_load_smplh()), seed=seed)
    model_dir = os.path.join(exp_dir, f"{model_id}-variant")
    os.makedirs(model_dir)
    j_cfg.to_json(os.path.join(model_dir, "config.json"))
    save_torch_checkpoint(os.path.join(model_dir, "model.pth"), params, state, j_cfg)


def parse_table(text: str) -> list:
    """The rows of the last printed metric table: [id, 6 numbers]."""
    lines = text.splitlines()
    rule = max(i for i, line in enumerate(lines)
               if line.strip() and set(line.replace(" ", "")) == {"-"})
    rows = []
    for line in lines[rule + 1:]:
        toks = line.split()
        if len(toks) < 2 + len(METRIC_NAMES) or not re.fullmatch(r"\d+", toks[0]):
            break
        rows.append([" ".join(toks[1:-6])] + [float(t) for t in toks[-6:]])
    return rows


def jax_rows(capsys, model_id, **kw) -> list:
    capsys.readouterr()
    jax_eval_main(argparse.Namespace(model_id=model_id, cross_subject=False, window_size=None,
                                     **kw))
    return parse_table(capsys.readouterr().out)


def assert_rows_equal(got, want, msg):
    assert [r[0] for r in got] == [r[0] for r in want], msg
    assert want[-1][0] == "Overall average" and len(want) == 3, msg
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1:], w[1:], **TOL, err_msg=f"{msg} {w[0]}")


@pytest.fixture()
def experiments(assets_env, tmp_path, monkeypatch):
    exp_dir = str(tmp_path / "experiments")
    os.makedirs(exp_dir)
    monkeypatch.setenv("EM_EXPERIMENTS", exp_dir)
    return exp_dir


def check_family(experiments, capsys, kind, n_markers):
    """The port's three passes against the JAX CLI for one released variant."""
    model_id = f"91{RELEASED_VARIANTS.index((kind, n_markers)):02d}"
    write_experiment(experiments, model_id, variant_config(kind, n_markers),
                     seed=RELEASED_VARIANTS.index((kind, n_markers)))
    want = jax_rows(capsys, model_id)
    for mode in ([], ["--serial"], ["--host_metrics"]):
        rows, overall = cli.main(["--model_id", model_id, "--device", "cpu"] + mode)
        assert list(overall) == list(METRIC_NAMES)
        assert_rows_equal(rows, want, f"{kind}-{n_markers} {mode}")
        assert_rows_equal(parse_table(capsys.readouterr().out), want, f"printed {mode}")


def check_flag(experiments, capsys, kind, model_id, flags, **kw):
    """One CLI flag (``--cross_subject``, ``--window_size``) in both CLIs."""
    write_experiment(experiments, model_id, variant_config(kind, 12), seed=5)
    capsys.readouterr()
    jax_eval_main(argparse.Namespace(model_id=model_id, **dict(
        dict(cross_subject=False, window_size=None), **kw)))
    want = parse_table(capsys.readouterr().out)
    rows, _ = cli.main(["--model_id", model_id, "--device", "cpu"] + flags)
    assert [r[0] for r in rows] == [r[0] for r in want] and len(rows) >= 2
    for g, w in zip(rows, want):
        np.testing.assert_allclose(g[1:], w[1:], **TOL, err_msg=f"{kind} {flags} {w[0]}")
    return rows


@pytest.mark.parametrize("kind, n_markers",
                         [v for v in RELEASED_VARIANTS if not v[0].startswith("lgd")])
def test_cli_rows_match_jax_cli(experiments, capsys, kind, n_markers):
    check_family(experiments, capsys, kind, n_markers)


def test_cli_window_size(experiments, capsys):
    """--window_size 16: a BiRNN streamed in windows of 16 frames, its
    carry threaded from window to window."""
    check_flag(experiments, capsys, "rnn", "9200", ["--window_size", "16"], window_size=16)


def test_cli_refusals(experiments):
    write_experiment(experiments, "9300", variant_config("resnet", 6), seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--model_id", "9300", "--device", "cpu", "--suppression_length", "0.5"])
    with pytest.raises(FileNotFoundError, match="experiment"):
        cli.main(["--model_id", "9399", "--device", "cpu"])


def test_fit_crosses_an_eval_boundary(experiments, capsys):
    """--eval_every 3 over 3 steps: one validation and test pass at step 2,
    which writes the best-test checkpoint; the final passes run on it, and
    their test metrics equal the eval CLI's on the checkpoint's model.pth."""
    model_dir, trainer = train_main(TINY_LGD + ["--experiment_id", "9400", "--eval_every", "3",
                                                "--max_steps", "3"])
    out = capsys.readouterr().out
    assert trainer.global_step == 3
    assert len(re.findall(r"^\[VALID 0000\d \| 00\d\] ", out, re.M)) == 1
    assert len(re.findall(r"^\[TEST  0000\d \| 00\d\] .* \*\*\*$", out, re.M)) == 1
    state = torch.load(os.path.join(model_dir, "checkpoint", "train_state.pt"),
                       map_location="cpu", weights_only=True)
    assert state["global_step"] == 2 and np.isfinite(state["best_test_loss"])
    final = out[out.index("[TEST FINAL]"):]
    header, rule, row = final.splitlines()[1:4]
    assert header.split()[0] == "Model" and set(rule.replace(" ", "")) == {"-"}
    assert row.split()[0] == "9400"
    final_metrics = [float(t) for t in row.split()[1:]]
    _, overall = cli.main(["--model_id", "9400", "--device", "cpu"])
    np.testing.assert_allclose(final_metrics, list(overall.values()), **TOL)


def test_cli_visualize_writes_artifacts(experiments):
    """--visualize 1 runs the serial pass (the same rows) and writes the
    second recording's npz and frame-0 OBJ meshes into <model_dir>/visualize."""
    write_experiment(experiments, "9500", variant_config("rnn", 6), seed=2)
    rows, _ = cli.main(["--model_id", "9500", "--device", "cpu"])
    vis_rows, _ = cli.main(["--model_id", "9500", "--device", "cpu", "--visualize", "1"])
    for g, w in zip(vis_rows, rows):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5, atol=1e-4)
    vis = os.path.join(experiments, "9500-variant", "visualize")
    seq_id = rows[1][0]
    assert sorted(os.listdir(vis)) == sorted([f"{seq_id}.npz", f"{seq_id}_frame0_gt.obj",
                                              f"{seq_id}_frame0_pred.obj"])
    with np.load(os.path.join(vis, f"{seq_id}.npz")) as z:
        assert z["joints_hat"].shape == z["joints_gt"].shape == (40, 22, 3)
        assert z["verts_hat"].shape == z["verts_gt"].shape and np.isfinite(z["verts_hat"]).all()


def test_load_model_and_eval_data_partitions(experiments):
    """The three partitions' loaders give the JAX package's batches byte for
    byte: 3DPW middle windows of the model's window size, the recordings,
    the hold-out recording."""
    from empose_tpu.eval.harness import load_model_and_eval_data as jax_load
    from empose_tpu_torch.eval.harness import load_model_and_eval_data
    write_experiment(experiments, "9600", variant_config("rnn", 12), seed=3)
    for partition in ("valid", "test_real", "test_real_0715"):
        session, loader, config = load_model_and_eval_data("9600", partition, device="cpu")
        _, want_loader, _ = jax_load("9600", partition)
        assert config.window_size == 16 and session.device.type == "cpu"
        got, want = list(loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) and list(g["ids"]) == list(w["ids"])
            for k in w:
                if k != "ids":
                    assert np.array_equal(g[k], w[k]), (partition, k)
    with pytest.raises(ValueError, match="partition"):
        load_model_and_eval_data("9600", "train", device="cpu")


def test_valid_pass_draws_alike_every_pass(experiments):
    """Trainer.evaluate_valid: the same losses and metrics on every pass
    (fixed draws per batch), the trainer's own random stream untouched, the
    model back in training mode; the metrics equal the host oracle's on the
    same synthesized batches."""
    from empose_tpu_torch.config import Configuration
    from empose_tpu_torch.data.datasets import EMRBatchLoader
    from empose_tpu_torch.eval.metrics import MetricsEngine
    from empose_tpu_torch.train.loop import EVAL_SEED, Trainer
    from empose_tpu_torch import constants as C
    cfg = Configuration(vars(Configuration.parser().parse_args(TINY_LGD[:-2])))  # no --device
    trainer = Trainer(cfg, device="cpu")
    loader = EMRBatchLoader(os.path.join(C.data_dir_synth(), "3dpw_emr"), 2, 16, shuffle=False,
                            window_mode="middle")
    state = trainer.generator.get_state()
    me = MetricsEngine(trainer.smplh, "cpu")
    first = trainer.evaluate_valid(loader, me), me.get_metrics()
    second = trainer.evaluate_valid(loader, me), me.get_metrics()
    assert first == second and trainer.model.training
    assert torch.equal(trainer.generator.get_state(), state)
    oracle = MetricsEngine(trainer.smplh, "cpu")
    trainer.model.eval()
    with torch.no_grad():
        for b_idx, host_batch in enumerate(loader):
            g = torch.Generator().manual_seed(EVAL_SEED + b_idx)
            batch = trainer.pre_eval(trainer.upload(host_batch), g, mode="all")
            out, _ = trainer.model(batch, None)
            oracle.compute(pose=batch["poses"][:, :, 3:].numpy(), shape=batch["shapes"].numpy(),
                           pose_hat=out["pose_hat"].numpy(), shape_hat=out["shape_hat"].numpy(),
                           seq_lengths=batch["seq_lengths"].numpy(),
                           pose_root=batch["poses"][:, :, :3].numpy(),
                           pose_root_hat=out["root_ori_hat"].numpy())
    np.testing.assert_allclose(list(first[1].values()), list(oracle.get_metrics().values()),
                               rtol=1e-5, atol=1e-4)
