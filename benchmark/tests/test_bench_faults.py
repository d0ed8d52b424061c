"""A run whose timed path is broken underneath comes out not correct: the
rest of the run as the harness drives it, on the CPU at tiny widths."""

import pytest

from benchmark import faults
from benchmark.tests.tiny import run_cell, tiny_root

TRAIN = ("lgd_rnn6.train.b64w256", "birnn6.train.b64w256")
SERVE = ("lgd_rnn6.infer.s64c256", "lgd_rnn6.serve.live_c16")


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", faults.TRAIN, ids=lambda f: f.__name__)
def test_train_faults_are_caught(cell, fault, tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    fault(monkeypatch.setattr)
    res = run_cell(root, cell)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", faults.SERVE, ids=lambda f: f.__name__)
def test_serving_faults_are_caught(cell, fault, tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    fault(monkeypatch.setattr)
    res = run_cell(root, cell)
    assert not res["correct"], (res["compared"], res["failed"])
