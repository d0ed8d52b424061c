"""The port's serving bench (``python -m empose_tpu_torch.tools.bench_serve``)
on the CPU at its test widths: the lines of the JAX tool
(``tools/bench_serve.py``), and its numbers returned as a dict."""

import re

import pytest
import torch

from empose_tpu_torch.tools import bench_serve
from empose_tpu_torch.utils.experiments import count_parameters

torch.set_num_threads(1)
NUM = r"[\d.]+"
SINGLE = [
    r"chunk=4 frames  timed_chunks=3",
    rf"per-chunk latency: p50 {NUM} ms  p95 {NUM} ms  p99 {NUM} ms  max {NUM} ms",
    rf"added latency per frame \(p50\): {NUM} ms",
    rf"real-time budget at 60 fps: {NUM} ms/chunk -> {NUM}x headroom \(p50\), {NUM}x \(p99\)",
]
MULTI = [
    r"streams=4 chunk=4  timed_steps=3",
    rf"per-step latency \(all 4 sessions\): p50 {NUM} ms  p99 {NUM} ms",
    r"aggregate rate at p50: [\d,]+ frames/s",
    rf"real-time budget at 60 fps: {NUM} ms/chunk -> {NUM}x headroom \(p50\); "
    r"~[\d,]+ sustainable 60 fps sessions/chip at this latency",
]


@pytest.mark.parametrize("streams, lines", [(1, SINGLE), (4, MULTI)], ids=["single", "multi"])
def test_prints_the_jax_tools_lines(capsys, streams, lines):
    got = bench_serve.main(["--chunk", "4", "--n", "3", "--streams", str(streams),
                            "--device", "cpu", "--tiny"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(lines)
    for line, pattern in zip(out, lines):
        assert re.fullmatch(pattern, line), (line, pattern)
    assert got["streams"] == streams and got["n"] == 3 and got["forwards"] == 3 + 5
    assert 0 < got["p50"] <= got["p95"] <= got["p99"] <= got["max"]
    assert got["frames_per_s"] > 0


def test_flagship_is_lgd_rnn_6():
    """The tool's own copy of the flagship config builds the released
    LGD-RNN-6 (5,721,250 parameters), from a seed."""
    a, b = bench_serve.flagship_model("cpu"), bench_serve.flagship_model("cpu")
    assert count_parameters(a) == 5_721_250
    assert not a.training
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v), k
