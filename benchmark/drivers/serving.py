"""What the serving drivers share: the program's model and predictor, the
recorded sessions, and the check of served chunks against the reference.

A session plays a recording of the pool from a chunk-aligned offset,
looping; its chunk ``k`` is the same frames in the program and in the
reference. The program's ``MultiStreamPredictor`` carries each stream's
LSTM state from chunk to chunk; the reference follows a sampled stream
from its first chunk, carrying its own state, and runs the whole forward
on the chunks that were kept.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import assets as A
from benchmark.drivers import common as D

REF_ROWS = 32   # reference rows per forward


class Sessions:
    """``n`` sessions over a pool of recordings of ``frames`` frames."""

    def __init__(self, inputs, rng: np.random.Generator, n: int, pool: int, frames: int,
                 chunk: int):
        self.pos, self.ori, self.off_t, self.off_r = A.recorded_sessions(
            inputs.body(), inputs.bank(), rng, pool, frames, inputs.device)
        self.n, self.chunk, self.frames = n, chunk, frames
        self.source = np.arange(n) % pool
        self.start = chunk * rng.integers(0, frames // chunk, n)

    def chunk_of(self, i: int, k: int):
        a = (self.start[i] + k * self.chunk) % self.frames
        s = self.source[i]
        return self.pos[s, a:a + self.chunk], self.ori[s, a:a + self.chunk]

    def offsets(self, i: int):
        return self.off_t[self.source[i]], self.off_r[self.source[i]]


def program_model(run, inputs):
    """The configuration's model in the program, with the run's weights, in
    eval mode at the configuration's precision."""
    from empose_tpu_torch.bodymodel.smplh import load_smplh
    from empose_tpu_torch.config import Configuration
    from empose_tpu_torch.device import set_precision
    from empose_tpu_torch.nn.models import SensorSMPL, create_model

    set_precision(run.flags["matmul_precision"])
    model = create_model(Configuration.from_dict(run.flags), SensorSMPL(load_smplh()))
    model = model.to(inputs.device)
    model.load_state_dict(inputs.weights, strict=True)
    return model.eval()


def predictor(model, sessions: Sessions):
    """A fresh ``MultiStreamPredictor`` of every session, offsets set."""
    from empose_tpu_torch.serve import MultiStreamPredictor

    pred = MultiStreamPredictor(model, n_streams=sessions.n, chunk_size=sessions.chunk)
    for i in range(sessions.n):
        pred.set_offsets(i, *sessions.offsets(i))
    return pred


def reference_outputs(run, inputs, sessions: Sessions, kept: Dict[int, Dict[int, Dict]],
                      served: Dict[int, int], tf32: bool = False) -> Dict[int, Dict[int, Dict]]:
    """The reference's outputs for the kept chunks, in the program's form:
    a stream's shape estimate is the one of its chunk 0's first frame.

    :param kept: stream -> {chunk index -> anything}; every stream's chunk 0
      is among them.
    :param served: stream -> chunks served in order from chunk 0.
    :param tf32: compute with TF32 on (the control) instead of float32.
    """
    device, flags, mod = inputs.device, run.flags, inputs.mod
    D.reference_precision(tf32)
    body, p = inputs.body(), inputs.weights
    streams = sorted(kept)
    outs: Dict[int, Dict[int, Dict]] = {i: {} for i in streams}
    with torch.no_grad():
        for a in range(0, len(streams), REF_ROWS):
            rows = streams[a:a + REF_ROWS]
            offs = [sessions.offsets(i) for i in rows]
            window = {"offset_t": torch.as_tensor(np.stack([o[0] for o in offs]), device=device),
                      "offset_r": torch.as_tensor(np.stack([o[1] for o in offs]), device=device),
                      "seq_lengths": torch.full((len(rows),), sessions.chunk, device=device)}
            first: Dict[int, np.ndarray] = {}
            state = None
            for k in range(max(served[i] for i in rows)):
                parts = [sessions.chunk_of(i, k) for i in rows]
                window["marker_pos"] = torch.as_tensor(np.stack([x[0] for x in parts]), device=device)
                window["marker_ori"] = torch.as_tensor(np.stack([x[1] for x in parts]), device=device)
                if not any(k in kept[i] for i in rows):
                    state = mod.advance(p, window, flags, state, library=True)
                    continue
                out, state = mod.forward(p, body, window, flags, train=False, state=state,
                                         library=True)
                pose = out["pose"].cpu().numpy()
                shape = out["shape"].cpu().numpy() if "shape" in out else None
                for r, i in enumerate(rows):
                    if k >= served[i] or k not in kept[i]:
                        continue
                    res = {"root_ori": pose[r, :, :3], "pose_body": pose[r, :, 3:]}
                    if shape is not None:
                        first.setdefault(i, shape[r, 0])
                        res["shape"] = np.broadcast_to(first[i], shape[r].shape)
                    outs[i][k] = res
    D.reference_precision(False)
    return outs


def gaps(got: Dict[int, Dict[int, Dict]], ref: Dict[int, Dict[int, Dict]]) -> Dict[str, float]:
    """The compared numbers: the largest absolute gap of the root and body
    angle-axis (rad) and of the shape estimate over every kept chunk."""
    pose = shape = 0.0
    for i, chunks in ref.items():
        for k, want in chunks.items():
            have = got[i][k]
            pose = max(pose, float(np.abs(have["root_ori"] - want["root_ori"]).max()),
                       float(np.abs(have["pose_body"] - want["pose_body"]).max()))
            if "shape" in want:
                shape = max(shape, float(np.abs(have["shape"] - want["shape"]).max()))
    return {"pose_gap_rad": pose, "shape_gap": shape}


def sample(rng: np.random.Generator, n: int, k: int) -> List[int]:
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))
