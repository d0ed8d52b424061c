"""Noise in evaluation and training, and the suppression study, on the CPU.

A noise function that makes no draws (marker 3 zeroed in frames 2-4 of
every window) goes into both packages' ``EvalSession``: the port's rows
equal the JAX package's at the eval CLI tests' tolerance, which holds that
the noise sits at the same point of the pipeline. The eval CLI with
``--suppression_length`` repeats its rows, and its serial and host-oracle
rows agree; ``run_study`` has the grid's rows and a clean row equal to the
clean CLI's; ``check_monotone`` gives the JAX tool's verdicts; the train CLI
trains with each noise type and a resumed noisy run continues bit for bit.
The asset tree is ``tests/conftest.py``'s.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empose_tpu.data.batches import collate_real as j_collate_real
from empose_tpu.data.datasets import Loader as JLoader, RealDataset as JRealDataset
from empose_tpu.eval.harness import (EvalSession as JEvalSession,
                                     evaluate_real_sequences as j_evaluate,
                                     load_model as j_load_model)
from tools.suppression_study import check_monotone as j_check_monotone

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.data.batches import collate_real
from empose_tpu_torch.data.datasets import Loader, RealDataset
from empose_tpu_torch.eval import cli
from empose_tpu_torch.eval.harness import EvalSession, evaluate_real_sequences
from empose_tpu_torch.tools import suppression_study as study
from empose_tpu_torch.train.cli import main as train_main
from empose_tpu_torch.utils.experiments import load_model
from tests.test_torch_eval_cli import TOL, experiments, variant_config, write_experiment  # noqa: F401
from tests.test_torch_train_loop import TINY_LGD, _losses

torch.set_num_threads(1)
MARKER, FRAMES = 3, slice(2, 5)


def j_zero_marker(chunk, key):
    """Marker 3's position, orientation and normal zeroed in frames 2-4."""
    out = dict(chunk)
    for name, w in (("marker_pos", 3), ("marker_ori", 9), ("marker_nor", 3)):
        out[name] = chunk[name].at[:, FRAMES, MARKER * w:(MARKER + 1) * w].set(0.0)
    return out


def t_zero_marker(chunk, generator):
    out = dict(chunk)
    for name, w in (("marker_pos", 3), ("marker_ori", 9), ("marker_nor", 3)):
        v = chunk[name].clone()
        v[:, FRAMES, MARKER * w:(MARKER + 1) * w] = 0.0
        out[name] = v
    return out


def _loader(module_ds, module_loader, collate):
    return module_loader(module_ds(C.data_dir_real()), batch_size=1, collate_fn=collate,
                         shuffle=False)


def _assert_rows_close(got, want, msg):
    assert [r[0] for r in got] == [r[0] for r in want], msg
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1:], w[1:], **TOL, err_msg=f"{msg} {w[0]}")


@pytest.mark.parametrize("kind, window", [("rnn", None), ("ief", 16)])
def test_noise_hook_sits_where_jax_puts_it(experiments, kind, window):  # noqa: F811
    """The drawless noise function in both sessions: the port's serial and
    host-oracle rows equal the JAX package's serial rows, and differ from
    the clean rows."""
    model_id = "9500" if kind == "rnn" else "9501"
    write_experiment(experiments, model_id, variant_config(kind, 12), seed=7)
    jm, params, state, _, _, sensor = j_load_model(model_id)
    want, _ = j_evaluate(JEvalSession(jm, params, state, sensor, noise_fn=j_zero_marker),
                         _loader(JRealDataset, JLoader, j_collate_real), window)
    want = [[r[0]] + [float(v) for v in r[1:]] for r in want]
    model, _, _ = load_model(model_id, device="cpu")
    smplh = load_smplh()
    for host in (False, True):
        session = EvalSession(model, smplh, noise_fn=t_zero_marker)
        rows, _ = evaluate_real_sequences(session, _loader(RealDataset, Loader, collate_real),
                                          window, host_metrics=host)
        _assert_rows_close(rows, want, f"{kind} host={host}")
    clean, _ = evaluate_real_sequences(EvalSession(model, smplh),
                                       _loader(RealDataset, Loader, collate_real), window)
    assert not np.allclose([r[1:] for r in clean], [r[1:] for r in want], rtol=1e-6)


def test_eval_cli_suppression_is_repeatable_and_passes_agree(experiments):  # noqa: F811
    """``--suppression_length 0.5 --suppression_markers 2`` on an LGD model
    in windows of 16: the same rows twice, the host oracle's rows equal the
    serial loop's (the default with noise), both other than the clean rows."""
    write_experiment(experiments, "9510", variant_config("ief", 6), seed=3)
    argv = ["--model_id", "9510", "--device", "cpu", "--window_size", "16",
            "--suppression_length", "0.5", "--suppression_markers", "2"]
    first, second = cli.main(argv)[0], cli.main(argv)[0]
    assert first == second and len(first) == 3
    _assert_rows_close(cli.main(argv + ["--host_metrics"])[0], first, "host oracle")
    _assert_rows_close(cli.main(argv + ["--serial"])[0], first, "serial")
    clean = cli.main(argv[:6])[0]
    assert clean != first


def test_study_grid_and_clean_row(experiments, capsys, tmp_path):  # noqa: F811
    """Lengths 0, 0.5 x markers 1, 2: the clean row, then one row per
    marker count at 0.5; the clean row is the clean CLI's overall row; the
    table prints without tabulate and ``--out`` writes the verdict."""
    write_experiment(experiments, "9520", variant_config("ief", 12), seed=4)
    out = str(tmp_path / "study.json")
    rc = study.main(["--model_id", "9520", "--lengths", "0,0.5", "--markers", "1,2",
                     "--device", "cpu", "--out", out])
    text = capsys.readouterr().out
    with open(out) as f:
        result = json.load(f)
    rows = result["rows"]
    assert [(r["suppression_markers"], r["suppression_length"]) for r in rows] == \
        [(0, 0.0), (1, 0.5), (2, 0.5)]
    assert rc == (0 if result["monotone_ok"] else 1)
    assert result["violations"] == study.check_monotone(rows)
    assert "dropped markers" in text and "dropout length (frac of window)" in text
    _, overall = cli.main(["--model_id", "9520", "--device", "cpu"])
    assert {k: v for k, v in rows[0].items() if k not in study.GRID_KEYS} == \
        {k: round(float(v), 3) for k, v in overall.items()}
    assert all(rows[0] != r for r in rows[1:])


def _rows(values):
    return [{"suppression_markers": m, "suppression_length": length, "MPJPE [mm]": v}
            for (m, length), v in values.items()]


MONOTONE_CASES = {
    "monotone_grid_passes": ({(0, 0.0): 50.0, (1, 0.25): 55.0, (1, 0.5): 60.0,
                              (2, 0.25): 58.0, (2, 0.5): 70.0}, []),
    "small_noise_within_tolerance_passes": ({(0, 0.0): 50.0, (1, 0.25): 48.6,
                                             (1, 0.5): 52.0}, []),
    "length_violation_flags": ({(0, 0.0): 50.0, (1, 0.25): 55.0, (1, 0.5): 40.0},
                               ["markers=1"]),
    "marker_count_violation_flags": ({(0, 0.0): 50.0, (1, 0.5): 60.0, (2, 0.5): 59.5,
                                      (1, 0.25): 55.0, (2, 0.25): 52.5}, ["length=0.25"]),
}


@pytest.mark.parametrize("case", list(MONOTONE_CASES))
def test_check_monotone_matches_jax_tool(case):
    """The cases of ``tests/test_suppression_tools.py``: the port's check
    gives the JAX tool's violations, word for word."""
    values, flagged = MONOTONE_CASES[case]
    got = study.check_monotone(_rows(values))
    assert got == j_check_monotone(_rows(values))
    assert len(got) == len(flagged) and all(s in v for s, v in zip(flagged, got))


NOISE_FLAGS = {"spherical": ["--spherical_noise_strength", "0.5", "--spherical_noise_length",
                             "0.5"],
               "suppression": ["--suppression_noise_length", "0.5", "--noise_num_markers", "2"]}


@pytest.mark.parametrize("kind", list(NOISE_FLAGS))
def test_noisy_training_resumes_bit_for_bit(assets_env, tmp_path, monkeypatch, kind):
    """Each noise type through the train CLI: 2 steps then ``--resume`` to
    4 equal an uninterrupted 4-step run bit for bit (losses and weights),
    the losses are finite and differ from a clean run's, and the experiment
    name carries the noise."""
    monkeypatch.setenv("EM_EXPERIMENTS", str(tmp_path))
    flags = TINY_LGD + NOISE_FLAGS[kind]
    full_dir, full = train_main(flags + ["--experiment_id", "760001", "--max_steps", "4"])
    suffix = {"spherical": "-noise-spher-0.5", "suppression": "-noise-supp-0.5"}[kind]
    assert os.path.basename(full_dir).endswith(suffix)
    train_main(flags + ["--experiment_id", "760002", "--max_steps", "2"])
    part_dir, resumed = train_main(flags + ["--experiment_id", "760002", "--max_steps", "4",
                                            "--resume"])
    want, got = _losses(full_dir), _losses(part_dir)
    assert sorted(got) == [1, 2, 3, 4] and got == want
    assert all(np.isfinite(v) for v in got.values())
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    clean_dir, _ = train_main(TINY_LGD + ["--experiment_id", "760003", "--max_steps", "1"])
    assert _losses(clean_dir)[1] != want[1]


def test_noise_inputs_stay_on_the_session_device(experiments):  # noqa: F811
    """The session's noise sees each window on the session's device with
    its clipped valid frames, one window index after another."""
    write_experiment(experiments, "9530", variant_config("ief", 6), seed=2)
    model, _, _ = load_model("9530", device="cpu")
    seen = []

    def spy(chunk, generator):
        seen.append((chunk["marker_pos"].device.type, chunk["seq_lengths"].tolist(),
                     generator.initial_seed()))
        return chunk

    session = EvalSession(model, load_smplh(), noise_fn=spy)
    evaluate_real_sequences(session, _loader(RealDataset, Loader, collate_real), 16)
    assert [s[2] for s in seen] == [8004 + i for i in range(len(seen))]
    # 2 recordings of 40 frames, collated to 64: 4 windows each, the last empty.
    assert all(s[0] == "cpu" for s in seen) and len(seen) == 8
    assert [s[1] for s in seen[:4]] == [[16], [16], [8], [0]]
