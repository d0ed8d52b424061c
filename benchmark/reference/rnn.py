"""Plain (Bi)RNN model (EM-POSE's BiRNN): a (bidirectional) LSTM over the
window, a linear pose head and a shape MLP without BatchNorm whose output is
averaged over the window's frames. The loss is the squared error of the
body and root angle-axis, summed over joints, plus the L1 shape error."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import body as B
from benchmark.reference import common as C
from benchmark.reference import nn as R

POSE, SHAPE = (B.BODY_JOINTS + 1) * 3, B.N_BETAS
SHAPE_BLOCKS = 2


def spec(flags: Dict):
    """Parameters and buffers as (state-dict key, shape, init)."""
    if flags["m_learn_init_state"] or flags["m_skip_connections"] or flags["m_fk_loss"] > 0:
        raise ValueError("the reference builds the released BiRNN: no learned initial state, "
                         "no skip connections, no FK loss")
    d = flags["n_markers"] * (3 * bool(flags["use_marker_pos"]) + 9 * bool(flags["use_marker_ori"]))
    h, dirs = flags["m_hidden_size"], 2 if flags["m_bidirectional"] else 1
    spec = (R.lstm_spec("rnn.lstm", d, h, flags["m_num_layers"], flags["m_bidirectional"])
            + R.linear_spec("to_pose", h * dirs, POSE))
    if flags["m_estimate_shape"]:
        spec += R.mlp_spec("to_shape", h * dirs, SHAPE, flags["m_shape_hidden_size"],
                           SHAPE_BLOCKS, False)
    return spec


def advance(p, window: Dict, flags: Dict, state, library: bool = False):
    """The LSTM's state after ``window`` (what a stream carries)."""
    return R.lstm(p, "rnn.lstm", C.sensor_input(window, flags), window["seq_lengths"],
                  flags["m_num_layers"], flags["m_bidirectional"], state, library)[1]


def forward(p, body, window: Dict, flags: Dict, train: bool, state: Optional[tuple] = None,
            library: bool = False):
    """One window: ``(out, final LSTM state)`` with ``pose`` (N, F, 66) and
    ``shape`` (N, F, 10) where estimated."""
    x = C.sensor_input(window, flags)
    seq, new_state = R.lstm(p, "rnn.lstm", x, window["seq_lengths"], flags["m_num_layers"],
                            flags["m_bidirectional"], state, library)
    out = {"pose": R.linear(p, "to_pose", seq)}
    if flags["m_estimate_shape"]:
        shape = R.mlp(p, "to_shape", seq, SHAPE_BLOCKS, False, train)
        if flags["m_average_shape"]:
            shape = shape.mean(1, keepdim=True).expand(shape.shape)
        out["shape"] = shape
    return out, new_state


def loss(body, batch: Dict, out: Dict, flags: Dict):
    """(total, extra): the training loss and a zero (no value-zero term)."""
    poses, lengths = batch["poses"], batch["seq_lengths"]
    n, f = poses.shape[:2]
    total = (C.sq_loss(poses[..., 3:].reshape(n, f, -1, 3), out["pose"][..., 3:].reshape(n, f, -1, 3),
                       lengths)
             + C.sq_loss(poses[..., :3].reshape(n, f, 1, 3), out["pose"][..., :3].reshape(n, f, 1, 3),
                         lengths))
    if flags["m_estimate_shape"]:
        total = total + C.l1_loss(batch["shapes"][:, None].expand(n, f, SHAPE), out["shape"],
                                  lengths)
    return total, torch.zeros((), device=poses.device)
