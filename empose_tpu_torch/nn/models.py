"""The LGD model (IterativeErrorFeedback) and its SMPL-H sensor bundle, forward only.

Port of ``empose_tpu/nn/models.py``: ``SensorSMPL`` with the row-major FK
semantics of ``markers_and_joints_row_major``/``estimated_markers``,
``BaseModel.prepare_inputs``, ``IterativeErrorFeedback.forward`` and
``create_model`` for ``ief``/``lgd``.

The learned-gradient input is the gradient of the sensor reconstruction
error with respect to the current pose and shape, scaled by n*f. It is taken
with ``torch.autograd.grad`` under ``torch.enable_grad()``, so the forward
works inside ``torch.no_grad()`` (but not ``torch.inference_mode()``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import ARRAY_FIELDS, SMPLHModel, fold_zero_pose_joints, smplh_fk
from empose_tpu_torch.data import virtual_sensors as vsens
from empose_tpu_torch.nn import layers as L
from empose_tpu_torch.nn import losses as LS


def create_model(config, sensor_smpl: "SensorSMPL") -> nn.Module:
    """Factory keyed on ``config.m_type`` (module on the CPU, eval mode)."""
    if config.m_type in ("ief", "lgd"):
        return IterativeErrorFeedback(config, sensor_smpl).eval()
    if config.m_type in ("rnn", "resnet"):
        raise NotImplementedError(
            f"m_type={config.m_type!r} is not ported yet: ROADMAP.md, queue 1, "
            "'SimpleRNN and FeedForwardResNet'")
    raise ValueError(f"Model type '{config.m_type}' unknown.")


class SensorSMPL(nn.Module):
    """SMPL-H and virtual sensors specialized to the 12 marker vertices.

    Holds the subset body model (hand joints folded into the wrists, exact at
    the zero hand pose every caller uses) and the sensor tables as
    non-persistent buffers: they follow ``.to(device)`` and stay out of the
    state dict.
    """

    def __init__(self, smplh: SMPLHModel, vertex_ids=C.VERTEX_IDS):
        super().__init__()
        req, tables = vsens.subset_tables(smplh.faces, vertex_ids)
        self.sub = fold_zero_pose_joints(smplh.subset(req), C.N_JOINTS + 1)
        self.tables = tables
        sub_t, tables_t = self.sub.to("cpu"), tables.to("cpu")
        for name in ARRAY_FIELDS:
            self.register_buffer(f"sub_{name}", getattr(sub_t, name), persistent=False)
        for name in vsens.INDEX_FIELDS:
            self.register_buffer(f"tables_{name}", getattr(tables_t, name), persistent=False)

    def _sub_model(self) -> SMPLHModel:
        return SMPLHModel(**{name: getattr(self, f"sub_{name}") for name in ARRAY_FIELDS},
                          parents=self.sub.parents, faces=self.sub.faces,
                          vertex_ids=self.sub.vertex_ids)

    def _tables(self) -> vsens.VirtualSensorTables:
        t = self.tables
        return vsens.VirtualSensorTables(
            t.vertex_ids, *(getattr(self, f"tables_{name}") for name in vsens.INDEX_FIELDS))

    def markers_and_joints(self, poses: torch.Tensor, shapes: torch.Tensor, trans=None):
        """Subset FK -> virtual sensor frames (no offsets applied).

        :return: (pos (B, M, 3), ori (B, M, 3, 3), normals (B, M, 3), joints (B, 22, 3))
        """
        verts, joints = smplh_fk(self._sub_model(), poses[:, 3:], shapes,
                                 poses_root=poses[:, :3], trans=trans)
        pos, ori, nor = vsens.virtual_pos_and_rot(verts, self._tables())
        return pos, ori, nor, joints[:, : C.N_JOINTS + 1]

    def estimated_markers(self, poses, shapes, offset_r, offset_t):
        """Apply mounting offsets to the virtual frames.

        :param poses: (B, 66); :param shapes: (B, 10);
        :param offset_r: (B, M, 3, 3); :param offset_t: (B, M, 3).
        :return: (marker_pos (B, M, 3), marker_ori (B, M, 3, 3), joints (B, 22, 3))
        """
        pos, ori, _, joints = self.markers_and_joints(poses, shapes)
        return pos + (ori @ offset_t[..., None])[..., 0], ori @ offset_r, joints


def _average_over_frames(x: torch.Tensor) -> torch.Tensor:
    """Per-sequence mean over ALL frames (padding included), re-broadcast."""
    return x.mean(dim=1, keepdim=True).expand(x.shape)


class IterativeErrorFeedback(nn.Module):
    """The LGD model: an initial estimate (init RNN or MLPs), then N
    refinement steps fed with the sensors, the current estimate and
    (``m_use_gradient``) the scaled gradient of the reconstruction error."""

    def __init__(self, config, sensor_smpl: SensorSMPL):
        super().__init__()
        self.config = config
        self.smpl = sensor_smpl
        self.n_markers = config.n_markers if getattr(config, "n_markers", -1) > -1 else C.N_TRACKERS_WO_ROOT
        if self.n_markers not in (6, 12):
            raise ValueError(f"n_markers must be 6 or 12, got {self.n_markers}")
        if config.use_marker_nor:
            raise ValueError("Normals currently not supported.")
        self.N = config.m_num_iterations
        self.step_size = config.m_step_size
        self.use_gradient = config.m_use_gradient
        self.rnn_init = config.m_rnn_init
        self.shape_avg = config.m_average_shape
        self.marker_idxs = tuple(range(12)) if self.n_markers == 12 else C.S_CONFIG_6
        self.register_buffer("marker_sel", torch.tensor(self.marker_idxs), persistent=False)

        self.pos_d_start = self.pos_d_end = self.ori_d_start = self.ori_d_end = 0
        input_size = 0
        if config.use_marker_pos:
            input_size += self.n_markers * 3
            self.pos_d_end = self.n_markers * 3
            self.ori_d_start = self.pos_d_end
        if config.use_marker_ori:
            input_size += self.n_markers * 9
            self.ori_d_end = self.ori_d_start + self.n_markers * 9
        self.input_size = input_size
        self.pose_size = (C.N_JOINTS + 1) * 3
        self.shape_size = C.N_SHAPE_PARAMS
        self.input_iter_size = input_size + self.pose_size + self.shape_size
        if self.use_gradient:
            self.input_iter_size += self.pose_size + self.shape_size

        use_bn = not config.m_no_batch_norm
        mlp_kw = dict(use_batch_norm=use_bn, skip_connection=config.m_skip_connections)
        if self.rnn_init:
            self.rnn = L.RNNLayer(input_size, config.m_rnn_hidden_size, config.m_rnn_num_layers,
                                  bidirectional=config.m_rnn_bidirectional)
            self.pose_net_init = L.Linear(config.m_rnn_hidden_size, self.pose_size)
            self.shape_net_init = L.Linear(config.m_rnn_hidden_size, self.shape_size)
        else:
            self.pose_net_init = L.MLP(input_size, self.pose_size, config.m_hidden_size,
                                       config.m_num_layers, **mlp_kw)
            self.shape_net_init = L.MLP(input_size, self.shape_size, config.m_hidden_size,
                                        config.m_num_layers, **mlp_kw)
        self.pose_net_iter = L.MLP(self.input_iter_size, self.pose_size, config.m_hidden_size,
                                   config.m_num_layers, **mlp_kw)
        self.shape_net_iter = L.MLP(self.input_iter_size, self.shape_size, config.m_hidden_size,
                                    config.m_num_layers, **mlp_kw)

    def initial_carry(self):
        """Streaming carry at sequence start."""
        return None

    def prepare_inputs(self, window: Dict) -> torch.Tensor:
        """Concatenate pos/ori features with the optional 6-marker subselect.

        ``window['marker_pos']`` (N, F, 12*3), ``window['marker_ori']`` (N, F, 12*9).
        """
        m_pos = window["marker_pos"]
        n, f = m_pos.shape[0], m_pos.shape[1]
        m_pos = m_pos.reshape(n, f, -1, 3)
        m_ori = window["marker_ori"].reshape(n, f, -1, 3, 3)
        if self.n_markers == 6:
            sel = list(C.S_CONFIG_6)
            m_pos, m_ori = m_pos[:, :, sel], m_ori[:, :, sel]
        feats = []
        if self.config.use_marker_pos:
            feats.append(m_pos.reshape(n, f, -1))
        if self.config.use_marker_ori:
            feats.append(m_ori.reshape(n, f, -1))
        return torch.cat(feats, dim=-1)

    def _recon_error(self, inputs_flat, marker_pos_hat, marker_ori_hat, n, f, seq_lengths,
                     marker_masks):
        """Reconstruction error of the estimated vs the input sensor readings."""
        sel = self.marker_sel
        err = inputs_flat.new_zeros(())
        if self.config.use_marker_pos:
            pos_in = inputs_flat[:, self.pos_d_start:self.pos_d_end].reshape(n, f, -1, 3)
            pos_hat = marker_pos_hat.reshape(n, f, -1, 3).index_select(2, sel)
            err = err + LS.reconstruction_loss(pos_in, pos_hat, seq_lengths, marker_masks)
        if self.config.use_marker_ori:
            ori_in = inputs_flat[:, self.ori_d_start:self.ori_d_end].reshape(n, f, -1, 9)
            ori_hat = marker_ori_hat.reshape(n, f, -1, 9).index_select(2, sel)
            err = err + LS.reconstruction_loss(ori_in, ori_hat, seq_lengths, marker_masks)
        return err

    def forward(self, window: Dict, carry=None):
        """One window of the LGD loop.

        :param window: marker_pos (N, F, 36), marker_ori (N, F, 108),
          seq_lengths (N,), offset_r (N, 12, 3, 3), offset_t (N, 12, 3),
          optional marker_masks (N, F, M).
        :param carry: the init RNN's (h, c) from the previous window, or None.
        :return: (out, new_carry); ``out`` holds pose_hat (N, F, 63),
          root_ori_hat (N, F, 3), shape_hat (N, F, 10), joints_hat (N, F, 66)
          and ``history``: every step's pose, shape, joints, marker_pos and
          marker_ori stacked on a leading (N+1) axis.
        """
        if self.training:
            raise NotImplementedError(L.TRAINING_NOT_PORTED)
        x = self.prepare_inputs(window)
        n, f, dof = x.shape
        seq_lengths = window["seq_lengths"]
        marker_masks = window.get("marker_masks")
        offset_r = window["offset_r"][:, None].expand(n, f, -1, 3, 3).reshape(n * f, -1, 3, 3)
        offset_t = window["offset_t"][:, None].expand(n, f, -1, 3).reshape(n * f, -1, 3)
        inputs_flat = x.reshape(n * f, dof)

        new_carry = None
        if self.rnn_init:
            lstm_out, new_carry = self.rnn(x, seq_lengths, carry)
            pose_hat = self.pose_net_init(lstm_out).reshape(n * f, -1)
            shape_hat = self.shape_net_init(lstm_out).reshape(n * f, -1)
        else:
            pose_hat = self.pose_net_init(inputs_flat)
            shape_hat = self.shape_net_init(inputs_flat)

        def to_single_shape(s):
            return _average_over_frames(s.reshape(n, f, -1)).reshape(n * f, -1)

        if self.shape_avg:
            shape_hat = to_single_shape(shape_hat)

        def fk(pose, shape, with_grad: bool):
            """One FK per iterate. With ``with_grad`` the pose/shape enter as
            leaves, so the recon-error gradient can be taken afterwards."""
            if not with_grad:
                return (pose, shape) + self.smpl.estimated_markers(pose, shape, offset_r, offset_t)
            with torch.enable_grad():
                pose = pose.detach().requires_grad_()
                shape = shape.detach().requires_grad_()
                return (pose, shape) + self.smpl.estimated_markers(pose, shape, offset_r, offset_t)

        hist = {"pose": [], "shape": [], "joints": [], "marker_pos": [], "marker_ori": []}

        def record(pose, shape, mp, mo, joints):
            hist["pose"].append(pose.detach())
            hist["shape"].append(shape.detach())
            hist["joints"].append(joints.detach().reshape(n * f, -1))
            hist["marker_pos"].append(mp.detach().reshape(n * f, -1))
            hist["marker_ori"].append(mo.detach().reshape(n * f, -1))

        leaf_pose, leaf_shape, mp, mo, joints = fk(pose_hat, shape_hat,
                                                   self.use_gradient and self.N > 0)
        record(leaf_pose, leaf_shape, mp, mo, joints)
        scale = float(n * f)
        for i in range(self.N):
            inputs_step = [inputs_flat, hist["pose"][-1], hist["shape"][-1]]
            if self.use_gradient:
                with torch.enable_grad():
                    recon = self._recon_error(inputs_flat, mp, mo, n, f, seq_lengths, marker_masks)
                    g_pose, g_shape = torch.autograd.grad(recon, (leaf_pose, leaf_shape))
                inputs_step += [g_pose * scale, g_shape * scale]
            iter_in = torch.cat(inputs_step, dim=-1)
            pose_delta = self.pose_net_iter(iter_in)
            shape_delta = self.shape_net_iter(iter_in)
            if self.shape_avg:
                shape_delta = to_single_shape(shape_delta)
            pose_hat = hist["pose"][-1] + pose_delta * self.step_size
            shape_hat = hist["shape"][-1] + shape_delta * self.step_size
            leaf_pose, leaf_shape, mp, mo, joints = fk(
                pose_hat, shape_hat, self.use_gradient and i + 1 < self.N)
            record(leaf_pose, leaf_shape, mp, mo, joints)

        history = {k: torch.stack([h.reshape(n, f, -1) for h in v]) for k, v in hist.items()}
        pose_final = history["pose"][-1]
        out = {
            "pose_hat": pose_final[:, :, 3:],
            "root_ori_hat": pose_final[:, :, :3],
            "shape_hat": history["shape"][-1],
            "joints_hat": history["joints"][-1],
            "history": history,
        }
        return out, new_carry
