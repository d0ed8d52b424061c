"""A copy of the benchmark whose configurations and traffic are cut to a
size the CPU runs in seconds, for the tests."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.tests.conftest import ROOT

TINY_FLAGS = {"m_hidden_size": 16, "m_rnn_hidden_size": 16, "m_num_layers": 1,
              "m_rnn_num_layers": 1, "m_shape_hidden_size": 8}
TINY_TRAFFIC = {
    "train": {"batch": 3, "window": 8, "pool": 4, "warmup": 1, "trace_seconds": 0.2},
    "replay": {"streams": 5, "chunk": 8, "session_frames": 32, "trace_seconds": 0.2,
               "sample_streams": 3, "sample_share": 0.3, "warmup": 1},
    "live": {"sessions": 12, "chunk": 4, "pool_sessions": 4, "session_frames": 64,
             "trace_seconds": 0.2, "sample_sessions": 3, "warmup": 2, "drain_seconds": 10},
}


def load(path):
    with open(path) as f:
        return json.load(f)


def save(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_root(tmp) -> str:
    """A checkout-like root holding BENCHMARK.json and benchmark/, cut to tiny sizes."""
    root = str(tmp)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in os.listdir(os.path.join(root, "benchmark", "configs")):
        path = os.path.join(root, "benchmark", "configs", name)
        cfg = load(path)
        cfg["flags"].update(TINY_FLAGS)
        save(path, cfg)
    for name in os.listdir(os.path.join(root, "benchmark", "traffic")):
        path = os.path.join(root, "benchmark", "traffic", name)
        tr = load(path)
        tr.update(TINY_TRAFFIC[tr["driver"]])
        save(path, tr)
    return root


def run_cell(root: str, cell: str, trace: bool = False, seconds: float = 0.3, seed: int = 2 ** 31 + 11):
    from benchmark import harness
    run = harness.Run(root, cell, seed, seconds, trace, device="cpu")
    return harness.execute(run)
