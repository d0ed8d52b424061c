"""Plain LGD model (learned gradient descent, EM-POSE's LGD-RNN): an init
LSTM gives a first pose and shape per frame; each of N refinement steps
feeds the sensors, the current estimate and the gradient of the sensor
reconstruction error with respect to that estimate (scaled by the number
of frames) to two MLPs, whose outputs move the estimate by ``step_size``.

Training keeps the whole history in the graph; only the MLPs' inputs are
detached. The loss averages, over the N + 1 estimates, the L1 pose and
shape errors, the FK joint error of the final estimate and the sensor
reconstruction error. Each refinement step's reconstruction error also adds
its parameter gradient once more (the value-zero term ``extra``), as the
released training code's ``backward()`` inside the forward does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import body as B
from benchmark.reference import common as C
from benchmark.reference import nn as R

POSE, SHAPE = (B.BODY_JOINTS + 1) * 3, B.N_BETAS


def _sizes(flags: Dict):
    d = flags["n_markers"] * (3 * bool(flags["use_marker_pos"]) + 9 * bool(flags["use_marker_ori"]))
    it = d + POSE + SHAPE + (POSE + SHAPE) * bool(flags["m_use_gradient"])
    return d, it


def spec(flags: Dict):
    """Parameters and buffers as (state-dict key, shape, init)."""
    if not flags["m_rnn_init"] or flags["m_rnn_bidirectional"] or flags["m_skip_connections"]:
        raise ValueError("the reference builds the released LGD-RNN: a unidirectional init "
                         "LSTM and MLPs without skip connections")
    d, it = _sizes(flags)
    h, blocks, bn = flags["m_hidden_size"], flags["m_num_layers"], not flags["m_no_batch_norm"]
    rh = flags["m_rnn_hidden_size"]
    return (R.lstm_spec("rnn.lstm", d, rh, flags["m_rnn_num_layers"], False)
            + R.linear_spec("pose_net_init", rh, POSE) + R.linear_spec("shape_net_init", rh, SHAPE)
            + R.mlp_spec("pose_net_iter", it, POSE, h, blocks, bn)
            + R.mlp_spec("shape_net_iter", it, SHAPE, h, blocks, bn))


def _recon(flags, inp, pos, ori, n, f, lengths):
    sel = list(B.SENSORS_6) if flags["n_markers"] == 6 else list(range(12))
    k = len(sel)
    err = inp.new_zeros(())
    if flags["use_marker_pos"]:
        err = err + C.l2_sum_loss(inp[:, :3 * k].reshape(n, f, k, 3),
                                  pos.reshape(n, f, 12, 3)[:, :, sel], lengths)
    if flags["use_marker_ori"]:
        start = 3 * k * bool(flags["use_marker_pos"])
        err = err + C.l2_sum_loss(inp[:, start:start + 9 * k].reshape(n, f, k, 9),
                                  ori.reshape(n, f, 12, 9)[:, :, sel], lengths)
    return err


def advance(p, window: Dict, flags: Dict, state, library: bool = False):
    """The init LSTM's state after ``window`` (what a stream carries)."""
    x = C.sensor_input(window, flags)
    return R.lstm(p, "rnn.lstm", x, window["seq_lengths"], flags["m_rnn_num_layers"], False,
                  state, library)[1]


def forward(p, body: B.SensorBody, window: Dict, flags: Dict, train: bool,
            state: Optional[tuple] = None, library: bool = False):
    """One window: ``(out, final LSTM state)``; ``out`` holds ``pose`` (N, F,
    66: root then body), ``shape`` (N, F, 10), ``joints`` (N, F, 22, 3) and
    ``history`` (each estimate's pose, shape, sensor positions and
    orientations, and the refinement steps' reconstruction errors)."""
    x = C.sensor_input(window, flags)
    n, f, d = x.shape
    lengths = window["seq_lengths"]
    mask = C.frame_mask(lengths, f).reshape(n * f)
    off_t = window["offset_t"][:, None].expand(n, f, 12, 3).reshape(n * f, 12, 3)
    off_r = window["offset_r"][:, None].expand(n, f, 12, 3, 3).reshape(n * f, 12, 3, 3)
    inp = x.reshape(n * f, d)
    blocks, bn = flags["m_num_layers"], not flags["m_no_batch_norm"]
    step, scale = flags["m_step_size"], float(n * f)

    def average(s):
        if not flags["m_average_shape"]:
            return s
        return s.reshape(n, f, -1).mean(1, keepdim=True).expand(n, f, s.shape[-1]).reshape(n * f, -1)

    seq, new_state = R.lstm(p, "rnn.lstm", x, lengths, flags["m_rnn_num_layers"], False, state,
                            library)
    pose = R.linear(p, "pose_net_init", seq).reshape(n * f, POSE)
    shape = average(R.linear(p, "shape_net_init", seq).reshape(n * f, SHAPE))

    def estimate(pose, shape, want_grad: bool):
        if train or not want_grad:
            return (pose, shape) + B.sensor_readings(body, pose, shape, off_t, off_r)
        with torch.enable_grad():
            pose = pose.detach().requires_grad_()
            shape = shape.detach().requires_grad_()
            return (pose, shape) + B.sensor_readings(body, pose, shape, off_t, off_r)

    n_iter = flags["m_num_iterations"]
    hist = {"pose": [], "shape": [], "pos": [], "ori": [], "recon": []}
    pose, shape, pos, ori, joints = estimate(pose, shape, n_iter > 0 and flags["m_use_gradient"])
    for i in range(n_iter + 1):
        hist["pose"].append(pose)
        hist["shape"].append(shape)
        hist["pos"].append(pos)
        hist["ori"].append(ori)
        if i == n_iter:
            break
        feats = [inp, pose.detach(), shape.detach()]
        if flags["m_use_gradient"]:
            with torch.enable_grad():
                recon = _recon(flags, inp, pos, ori, n, f, lengths)
                g_pose, g_shape = torch.autograd.grad(recon, (pose, shape), retain_graph=train)
            hist["recon"].append(recon)
            feats += [g_pose * scale, g_shape * scale]
        feats = torch.cat(feats, -1)
        d_pose = R.mlp(p, "pose_net_iter", feats, blocks, bn, train, mask)
        d_shape = average(R.mlp(p, "shape_net_iter", feats, blocks, bn, train, mask))
        pose = pose + d_pose * step if train else pose.detach() + d_pose * step
        shape = shape + d_shape * step if train else shape.detach() + d_shape * step
        pose, shape, pos, ori, joints = estimate(pose, shape,
                                                 flags["m_use_gradient"] and i + 1 < n_iter)
    out = {"pose": pose.reshape(n, f, POSE), "shape": shape.reshape(n, f, SHAPE),
           "joints": joints.reshape(n, f, -1, 3), "history": hist}
    if not train:
        out = {k: v.detach() for k, v in out.items() if k != "history"}
    return out, new_state


def loss(body, batch: Dict, out: Dict, flags: Dict):
    """(total, extra): the training loss and the value-zero term."""
    poses, lengths = batch["poses"], batch["seq_lengths"]
    n, f = poses.shape[:2]
    hist = out["history"]
    inp = C.sensor_input(batch, flags).reshape(n * f, -1)
    shapes = batch["shapes"][:, None].expand(n, f, SHAPE)
    k = len(hist["pose"])
    pose_l = sum(C.l1_loss(poses, h.reshape(n, f, POSE), lengths) for h in hist["pose"])
    shape_l = sum(C.l1_loss(shapes, h.reshape(n, f, SHAPE), lengths) for h in hist["shape"])
    recon_l = sum(_recon(flags, inp, a, b, n, f, lengths) for a, b in zip(hist["pos"], hist["ori"]))
    fk_l = 0.0
    if flags["m_fk_loss"] > 0:
        fk_l = k * C.l2_sum_loss(batch["joints_gt"].reshape(n, f, -1, 3), out["joints"], lengths)
    total = (flags["m_pose_loss_weight"] * pose_l + flags["m_fk_loss"] * fk_l
             + flags["m_shape_loss_weight"] * shape_l
             + flags["m_reprojection_loss_weight"] * recon_l) / k
    extra = sum((r - r.detach() for r in hist["recon"]), torch.zeros((), device=poses.device))
    return total, extra
