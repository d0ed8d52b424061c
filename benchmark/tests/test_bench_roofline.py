"""The frozen least-time formulas hold the kernel table's own bounds, and
the reference's FLOP count is affine in rows x frames."""

import numpy as np
import pytest
import torch

from benchmark.metrics import roofline as R


@pytest.mark.parametrize("fn, args, want_ms", [
    (R.stack_s, (16, 64, 512, 2), 0.0962), (R.stack_s, (256, 64, 512, 2), 1.5385),
    (R.stack_s, (16, 1, 512, 2), 0.0038), (R.stack_s, (16, 64, 1024, 1), 0.1282),
    (R.train_fwd_s, (64, 16, 512), 0.0321), (R.train_fwd_s, (256, 64, 512), 0.5128),
    (R.train_bwd_s, (64, 100, 512), 0.2003), (R.train_bwd_s, (256, 64, 512), 0.5128)])
def test_least_times_match_the_kernel_table(fn, args, want_ms):
    assert fn(*args) * 1e3 == pytest.approx(want_ms, abs=6e-5)


def test_flop_count_is_affine_in_frames(tmp_path):
    from benchmark import flops
    from benchmark.tests.tiny import tiny_root

    root = tiny_root(tmp_path)
    from benchmark import harness
    from benchmark.drivers import common as D
    for cell in ("lgd_rnn6.train.b64w256", "birnn6.train.b64w256"):
        run = harness.Run(root, cell, 5, 0.1, False, device="cpu")
        run.tmp = str(tmp_path)
        inputs = D.Inputs(run, torch.device("cpu"))
        # the extension from two small sizes equals the count at a third
        got = flops.train_step(inputs, run.flags, 3, 6)
        want = flops._count(lambda: _one_step(inputs, run.flags, 3, 6))
        assert got == pytest.approx(want, rel=1e-9)
        fwd = flops.eval_forward(inputs, run.flags, 3, 6)
        assert 0 < fwd < got


def _one_step(inputs, flags, n, f):
    from benchmark import assets as A
    from benchmark.reference import common as RC
    batch = A.pose_windows(np.random.default_rng(0), n, f)
    batch = {k: torch.as_tensor(batch[k]) for k in ("poses", "shapes", "seq_lengths")}
    batch["seq_lengths"] = batch["seq_lengths"].long()
    p = {k: v.detach() for k, v in inputs.weights.items()}
    RC.train_step(inputs.mod, p, inputs.params(), {"t": 0, "m": {}, "v": {}}, inputs.body(),
                  A.offset_bank(inputs.subjects, "cpu"), batch, flags, torch.Generator().manual_seed(0))
