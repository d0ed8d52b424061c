"""FLOPs of one call of the timed path, counted on the plain reference.

``FlopCounterMode`` counts the reference's matrix products, the LSTM's
step products included (the reference's LSTM is a loop of products), and
the backward's. The count is independent of how the program computes the
same step. Every product of these models is per frame or per row (a
sequence's mounting offsets), so the count is a·rows·frames + b·rows + c:
it is taken at three small sizes on the CPU at the configuration's widths
and extended to the cell's shapes.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import assets as A
from benchmark.reference import common as RC

SMALL = ((1, 4), (2, 4), (1, 8))


def _count(fn: Callable[[], None]) -> float:
    with FlopCounterMode(display=False) as mode:
        fn()
    return float(mode.get_total_flops())


def affine(count_at: Callable[[int, int], float], n: int, f: int) -> float:
    c1, c2, c3 = (count_at(*size) for size in SMALL)   # (1, 4), (2, 4), (1, 8)
    per_frame = (c3 - c1) / 4
    per_row = c2 - c3
    return c1 + per_frame * (n * f - 4) + per_row * (n - 1)


def train_step(inputs, flags: Dict, n: int, f: int) -> float:
    """One training step: synthesis, forward, loss and gradients."""
    body, bank = inputs.body().to("cpu"), A.offset_bank(inputs.subjects, "cpu")
    p = {k: v.detach().to("cpu") for k, v in inputs.weights.items()}
    names = inputs.params()

    def at(rows: int, frames: int) -> float:
        batch = A.pose_windows(np.random.default_rng(0), rows, frames)
        batch = {k: torch.as_tensor(batch[k]) for k in ("poses", "shapes", "seq_lengths")}
        batch["seq_lengths"] = batch["seq_lengths"].long()
        adam = {"t": 0, "m": {}, "v": {}}
        gen = torch.Generator().manual_seed(0)
        return _count(lambda: RC.train_step(inputs.mod, dict(p), names, adam, body, bank, batch,
                                            flags, gen))

    return affine(at, n, f)


def eval_forward(inputs, flags: Dict, n: int, f: int) -> float:
    """One eval forward of a served window."""
    body = inputs.body().to("cpu")
    p = {k: v.detach().to("cpu") for k, v in inputs.weights.items()}

    def at(rows: int, frames: int) -> float:
        g = torch.Generator().manual_seed(0)
        window = {"marker_pos": torch.randn(rows, frames, 36, generator=g),
                  "marker_ori": torch.randn(rows, frames, 108, generator=g),
                  "seq_lengths": torch.full((rows,), frames, dtype=torch.long),
                  "offset_t": torch.zeros(rows, 12, 3), "offset_r": torch.eye(3).expand(rows, 12, 3, 3)}
        with torch.no_grad():
            return _count(lambda: inputs.mod.forward(p, body, window, flags, train=False))

    return affine(at, n, f)
