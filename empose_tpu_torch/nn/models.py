"""The model zoo (FeedForwardResNet, SimpleRNN/BiRNN, the LGD model) and its
SMPL-H sensor bundle.

Port of ``empose_tpu/nn/models.py``: ``SensorSMPL`` with the row-major FK
semantics of ``markers_and_joints_row_major``/``estimated_markers`` and
``joints``; ``BaseModel`` (input preparation, the FK of the FK loss, the
shared pose/shape/FK losses); ``FeedForwardResNet`` and ``SimpleRNN``
(forward, ``compute_loss``); ``IterativeErrorFeedback.forward`` (eval and
train), ``compute_loss``, ``reference_grad_extra_loss``; and
``create_model`` for every ``m_type``. A model's ``forward(window, carry,
generator)`` returns ``(out, new_carry)``; train mode is ``module.train()``.

The learned-gradient input is the gradient of the sensor reconstruction
error with respect to the current pose and shape, scaled by n*f. It is taken
with ``torch.autograd.grad`` under ``torch.enable_grad()``, so the eval
forward works inside ``torch.no_grad()`` (but not ``torch.inference_mode()``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import ARRAY_FIELDS, SMPLHModel, fold_zero_pose_joints, smplh_fk
from empose_tpu_torch.data import virtual_sensors as vsens
from empose_tpu_torch.nn import layers as L
from empose_tpu_torch.nn import losses as LS
from empose_tpu_torch.utils.precision import HIGHEST, resolve
from empose_tpu_torch.utils.profiling import span

# Matmul precision of the kinematics GEMMs of ``SensorSMPL.markers_and_joints``
# (``empose_tpu/ops/fk_lanes.py:_HI``, the lane-major FK whose counterpart in
# the port is this row-major FK): joint regression, shape and pose blends and
# the subset skinning blend. ``SensorSMPL.joints``, the metrics and the
# full-mesh LBS stay f32 at every mode, as in JAX.
_FK_PRECISION = HIGHEST


def set_fk_precision(name: str) -> None:
    """Switch the kinematics GEMM precision for every later forward."""
    global _FK_PRECISION
    _FK_PRECISION = resolve(name)


def fk_precision() -> str:
    return _FK_PRECISION


def create_model(config, sensor_smpl: "SensorSMPL") -> nn.Module:
    """Factory keyed on ``config.m_type`` (module on the CPU, eval mode)."""
    if config.m_type == "rnn":
        return SimpleRNN(config, sensor_smpl).eval()
    if config.m_type == "resnet":
        return FeedForwardResNet(config, sensor_smpl).eval()
    if config.m_type in ("ief", "lgd"):
        return IterativeErrorFeedback(config, sensor_smpl).eval()
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
                                 poses_root=poses[:, :3], trans=trans, precision=_FK_PRECISION)
        pos, ori, nor = vsens.virtual_pos_and_rot(verts, self._tables())
        return pos, ori, nor, joints[:, : C.N_JOINTS + 1]

    def joints(self, poses: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
        """FK joints only (root and body, no hands): (B, 66)."""
        _, joints = smplh_fk(self._sub_model(), poses[:, 3:], shapes, poses_root=poses[:, :3],
                             want_vertices=False)
        return joints[:, : C.N_JOINTS + 1].reshape(poses.shape[0], -1)

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


class BaseModel(nn.Module):
    """Input sizing, input preparation, the FK of the FK loss and the shared
    pose/shape/FK losses (``empose_tpu/nn/models.py::BaseModel``)."""

    def __init__(self, config, sensor_smpl: SensorSMPL):
        super().__init__()
        self.config = config
        self.smpl = sensor_smpl
        self.n_markers = config.n_markers if getattr(config, "n_markers", -1) > -1 else C.N_TRACKERS_WO_ROOT
        if self.n_markers not in (6, 12):
            raise ValueError(f"n_markers must be 6 or 12, got {self.n_markers}")
        if config.use_marker_nor:
            raise ValueError("Normals currently not supported.")
        self.estimate_shape = config.m_estimate_shape
        self.shape_avg = config.m_average_shape
        self.fk_loss_weight = config.m_fk_loss
        self.do_fk = self.fk_loss_weight > 0.0
        self.pose_weight = getattr(config, "m_pose_loss_weight", 1.0)
        self.shape_weight = getattr(config, "m_shape_loss_weight", 1.0)
        self.input_size = self.n_markers * (3 * bool(config.use_marker_pos)
                                            + 9 * bool(config.use_marker_ori))
        self.output_size = (C.N_JOINTS + 1) * 3

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

    def maybe_do_fk(self, pose_hat: torch.Tensor, shape_hat) -> Optional[torch.Tensor]:
        """FK joints (N, F, 66) for the FK loss, None without it."""
        if not self.do_fk:
            return None
        n, f = pose_hat.shape[0], pose_hat.shape[1]
        joints = self.smpl.joints(pose_hat.reshape(n * f, -1), shape_hat.reshape(n * f, -1))
        return joints.reshape(n, f, -1)

    def _pose_shape_out(self, pose_hat: torch.Tensor, shape_hat) -> Dict:
        """The output dict of the single-estimate models, with the FK joints."""
        return {"pose_hat": pose_hat[:, :, 3:], "root_ori_hat": pose_hat[:, :, :3],
                "shape_hat": shape_hat, "joints_hat": self.maybe_do_fk(pose_hat, shape_hat)}

    def compute_loss(self, batch: Dict, out: Dict):
        """Pose/root MSE + shape L1 + FK reconstruction loss
        (``BaseModel._common_losses``; the LGD model has its own).

        :return: (total, {pose, root_pose, shape, fk, total_loss}).
        """
        poses = batch["poses"]
        n, f = poses.shape[0], poses.shape[1]
        seq_lengths = batch["seq_lengths"]
        marker_masks = batch.get("marker_masks")
        pose_loss = LS.normal_mse(poses[:, :, 3:].reshape(n, f, -1, 3),
                                  out["pose_hat"].reshape(n, f, -1, 3), seq_lengths, marker_masks)
        root_pose_loss = LS.normal_mse(poses[:, :, :3].reshape(n, f, -1, 3),
                                       out["root_ori_hat"].reshape(n, f, -1, 3), seq_lengths,
                                       marker_masks)
        zero = poses.new_zeros(())
        shape_loss = fk_loss = zero
        if self.estimate_shape:
            shapes_rep = batch["shapes"][:, None].expand(n, f, batch["shapes"].shape[-1])
            shape_loss = LS.padded_loss(shapes_rep, out["shape_hat"], LS.l1, seq_lengths)
        if self.do_fk:
            joints_gt = batch["joints_gt"].reshape(n, f, -1, 3)
            joints_hat = out["joints_hat"].reshape(n, f, -1, 3)
            fk_loss = LS.reconstruction_loss(joints_gt, joints_hat, seq_lengths, marker_masks)
        total = pose_loss + root_pose_loss + shape_loss + self.fk_loss_weight * fk_loss
        vals = {"pose": pose_loss, "root_pose": root_pose_loss, "shape": shape_loss,
                "fk": fk_loss, "total_loss": total}
        return total, vals


def _shape_mlp(config, input_size: int) -> L.MLP:
    """The shape head of ResNet and SimpleRNN: an MLP of 2 hidden blocks
    without BatchNorm."""
    return L.MLP(input_size, C.N_SHAPE_PARAMS, config.m_shape_hidden_size, num_layers=2,
                 use_batch_norm=False, skip_connection=config.m_skip_connections,
                 dropout_p=config.m_dropout_hidden)


def _model_name_tail(model: BaseModel) -> str:
    c = model.config
    name = f"-shape{c.m_shape_hidden_size}{'-avg' if model.shape_avg else ''}"
    if model.do_fk:
        name += f"-fk{model.fk_loss_weight}"
    return name + f"-n{model.n_markers}-lr{c.lr}"


class FeedForwardResNet(BaseModel):
    """Per-frame ResNet: ``from_input``, ``m_num_layers`` residual blocks,
    ``to_pose`` and the optional shape MLP. It has no carry."""

    def __init__(self, config, sensor_smpl: SensorSMPL):
        super().__init__(config, sensor_smpl)
        self.hidden_size = config.m_hidden_size
        self.num_layers = config.m_num_layers
        self.from_input = L.Linear(self.input_size, self.hidden_size)
        self.blocks = nn.ModuleList([L.ResidualBlock(self.hidden_size)
                                     for _ in range(self.num_layers)])
        self.to_pose = L.Linear(self.hidden_size, self.output_size)
        if self.estimate_shape:
            self.to_shape = _shape_mlp(config, self.hidden_size)

    def model_name(self) -> str:
        """The architecture summary of experiment directory names."""
        return f"ResNet-{self.num_layers}x{self.hidden_size}" + _model_name_tail(self)

    def forward(self, window: Dict, carry=None, generator: Optional[torch.Generator] = None):
        """:param generator: dropout draws in training mode (None: no dropout).
        :return: (out, None)."""
        x = self.from_input(self.prepare_inputs(window))
        for block in self.blocks:
            x = block(x)
        shape_hat = None
        if self.estimate_shape:
            shape_hat = self.to_shape(x, None, generator)
            if self.shape_avg:
                shape_hat = _average_over_frames(shape_hat)
        return self._pose_shape_out(self.to_pose(x), shape_hat), None


class SimpleRNN(BaseModel):
    """(Bi)LSTM over the window, ``to_pose`` and the optional shape MLP.

    The streaming carry is the LSTM's final (h, c), (layers * dirs, N, H)
    each: for a BiRNN both directions' final states, the backward one taken
    at each window's first frame, as in the JAX package. With
    ``m_learn_init_state`` the learned frame-0 state wins over any carry on
    every window (the reference quirk)."""

    def __init__(self, config, sensor_smpl: SensorSMPL):
        super().__init__(config, sensor_smpl)
        self.hidden_size = config.m_hidden_size
        self.num_layers = config.m_num_layers
        self.bidirectional = config.m_bidirectional
        self.learn_init_state = config.m_learn_init_state
        dirs = 2 if self.bidirectional else 1
        self.rnn = L.RNNLayer(self.input_size, self.hidden_size, self.num_layers,
                              bidirectional=self.bidirectional,
                              learn_init_state=self.learn_init_state, dropout_p=config.m_dropout)
        self.to_pose = L.Linear(self.hidden_size * dirs, self.output_size)
        if self.estimate_shape:
            self.to_shape = _shape_mlp(config, self.hidden_size * dirs)

    def model_name(self) -> str:
        """The architecture summary of experiment directory names."""
        name = "RNN-" + "-".join([str(self.hidden_size)] * self.num_layers)
        return ("Bi" if self.bidirectional else "") + name + _model_name_tail(self)

    def forward(self, window: Dict, carry=None, generator: Optional[torch.Generator] = None):
        """:param carry: the LSTM's final (h, c) of the previous window, or None.
        :param generator: dropout draws in training mode (None: no dropout).
        :return: (out, new_carry)."""
        x = self.prepare_inputs(window)
        if self.learn_init_state:
            carry = None
        lstm_out, new_carry = self.rnn(x, window["seq_lengths"], carry, generator)
        shape_hat = None
        if self.estimate_shape:
            shape_hat = self.to_shape(lstm_out, None, generator)
            if self.shape_avg:
                shape_hat = _average_over_frames(shape_hat)
        return self._pose_shape_out(self.to_pose(lstm_out), shape_hat), new_carry


class IterativeErrorFeedback(BaseModel):
    """The LGD model: an initial estimate (init RNN or MLPs), then N
    refinement steps fed with the sensors, the current estimate and
    (``m_use_gradient``) the scaled gradient of the reconstruction error.

    Spans (``utils/profiling.span``) in both forwards: ``lgd.init`` (the
    init RNN or nets), ``lgd.fk`` (each of the N+1 FK + sensor blocks),
    ``lgd.grad`` (each reconstruction error and its gradient) and
    ``lgd.mlp`` (each step's iteration nets)."""

    def __init__(self, config, sensor_smpl: SensorSMPL):
        super().__init__(config, sensor_smpl)
        self.N = config.m_num_iterations
        self.step_size = config.m_step_size
        self.r_weight = config.m_reprojection_loss_weight
        self.use_gradient = config.m_use_gradient
        self.rnn_init = config.m_rnn_init
        self.marker_idxs = tuple(range(12)) if self.n_markers == 12 else C.S_CONFIG_6
        self.register_buffer("marker_sel", torch.tensor(self.marker_idxs), persistent=False)

        self.pos_d_start = self.pos_d_end = self.ori_d_start = self.ori_d_end = 0
        if config.use_marker_pos:
            self.pos_d_end = self.n_markers * 3
            self.ori_d_start = self.pos_d_end
        if config.use_marker_ori:
            self.ori_d_end = self.ori_d_start + self.n_markers * 9
        input_size = self.input_size
        self.pose_size = self.output_size
        self.shape_size = C.N_SHAPE_PARAMS
        self.input_iter_size = input_size + self.pose_size + self.shape_size
        if self.use_gradient:
            self.input_iter_size += self.pose_size + self.shape_size

        use_bn = not config.m_no_batch_norm
        mlp_kw = dict(use_batch_norm=use_bn, skip_connection=config.m_skip_connections,
                      dropout_p=config.m_dropout_hidden)
        if self.rnn_init:
            self.rnn = L.RNNLayer(input_size, config.m_rnn_hidden_size, config.m_rnn_num_layers,
                                  bidirectional=config.m_rnn_bidirectional,
                                  dropout_p=config.m_dropout)
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

    def model_name(self) -> str:
        """The architecture summary of experiment directory names."""
        c = self.config
        name = f"IEF-{c.m_num_layers}x{c.m_hidden_size}-N{self.N}"
        if self.rnn_init:
            name += "-{}RNN-{}x{}".format("Bi" if c.m_rnn_bidirectional else "",
                                          c.m_rnn_num_layers, c.m_rnn_hidden_size)
        name += f"-r{self.r_weight}-ws{c.window_size}-lr{c.lr}"
        name += "-grad" if self.use_gradient else ""
        name += "-skip" if c.m_skip_connections else ""
        return name + f"-n{self.n_markers}"

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

    def _offsets_flat(self, window: Dict, n: int, f: int):
        offset_r = window["offset_r"][:, None].expand(n, f, -1, 3, 3).reshape(n * f, -1, 3, 3)
        offset_t = window["offset_t"][:, None].expand(n, f, -1, 3).reshape(n * f, -1, 3)
        return offset_r, offset_t

    def forward(self, window: Dict, carry=None, generator: Optional[torch.Generator] = None):
        """One window of the LGD loop.

        :param window: marker_pos (N, F, 36), marker_ori (N, F, 108),
          seq_lengths (N,), offset_r (N, 12, 3, 3), offset_t (N, 12, 3),
          optional marker_masks (N, F, M).
        :param carry: the init RNN's (h, c) from the previous window, or None.
        :param generator: dropout draws in training mode (None: no dropout).
        :return: (out, new_carry); ``out`` holds pose_hat (N, F, 63),
          root_ori_hat (N, F, 3), shape_hat (N, F, 10), joints_hat (N, F, 66)
          and ``history``: every step's pose, shape, joints, marker_pos and
          marker_ori stacked on a leading (N+1) axis. In training mode the
          history keeps its graph and ``_recon_for_grad`` holds each
          refinement step's reconstruction error.

        The eval forward takes each step's learned-gradient input from an FK
        graph of its own, detaches the history and drops the graph after its
        ``autograd.grad``, so at most one FK graph is alive at a time:
        ``config.remat`` would save nothing here and applies to the train
        forward only.
        """
        if self.training:
            return self._forward_train(window, carry, generator)
        x = self.prepare_inputs(window)
        n, f, dof = x.shape
        seq_lengths = window["seq_lengths"]
        marker_masks = window.get("marker_masks")
        offset_r, offset_t = self._offsets_flat(window, n, f)
        inputs_flat = x.reshape(n * f, dof)

        def to_single_shape(s):
            return _average_over_frames(s.reshape(n, f, -1)).reshape(n * f, -1)

        new_carry = None
        with span("lgd.init"):
            if self.rnn_init:
                lstm_out, new_carry = self.rnn(x, seq_lengths, carry)
                pose_hat = self.pose_net_init(lstm_out).reshape(n * f, -1)
                shape_hat = self.shape_net_init(lstm_out).reshape(n * f, -1)
            else:
                pose_hat = self.pose_net_init(inputs_flat)
                shape_hat = self.shape_net_init(inputs_flat)
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

        with span("lgd.fk"):
            leaf_pose, leaf_shape, mp, mo, joints = fk(pose_hat, shape_hat,
                                                       self.use_gradient and self.N > 0)
            record(leaf_pose, leaf_shape, mp, mo, joints)
        scale = float(n * f)
        for i in range(self.N):
            inputs_step = [inputs_flat, hist["pose"][-1], hist["shape"][-1]]
            if self.use_gradient:
                with span("lgd.grad"):
                    with torch.enable_grad():
                        recon = self._recon_error(inputs_flat, mp, mo, n, f, seq_lengths,
                                                  marker_masks)
                        g_pose, g_shape = torch.autograd.grad(recon, (leaf_pose, leaf_shape))
                    inputs_step += [g_pose * scale, g_shape * scale]
            with span("lgd.mlp"):
                iter_in = torch.cat(inputs_step, dim=-1)
                pose_delta = self.pose_net_iter(iter_in)
                shape_delta = self.shape_net_iter(iter_in)
                if self.shape_avg:
                    shape_delta = to_single_shape(shape_delta)
                pose_hat = hist["pose"][-1] + pose_delta * self.step_size
                shape_hat = hist["shape"][-1] + shape_delta * self.step_size
            with span("lgd.fk"):
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

    def _forward_train(self, window: Dict, carry, generator: Optional[torch.Generator]):
        """Train-mode forward (``IterativeErrorFeedback.forward(train=True)``):
        the history keeps its graph; only the nets' inputs of each refinement
        step and the learned-gradient input are detached. BatchNorm takes its
        statistics over the valid frames; the iter nets, applied N times,
        update their running statistics N times.

        With ``config.remat`` each FK + sensor block runs under
        ``torch.utils.checkpoint`` (non-reentrant): the graph keeps its
        inputs only, and each backward through it (a step's
        ``autograd.grad``, the final one) recomputes its activations, the
        same ops on the same inputs, so the loss and the gradients equal
        those without it bit for bit. The recomputed tensors that a step's
        ``autograd.grad`` does not read (the joints, the operands of the
        fixed offsets) stay until the final backward; taking that gradient
        from an FK of its own instead held no less memory on the card
        (``PERF.md``, Findings)."""
        x = self.prepare_inputs(window)
        n, f, dof = x.shape
        seq_lengths = window["seq_lengths"]
        marker_masks = window.get("marker_masks")
        offset_r, offset_t = self._offsets_flat(window, n, f)
        inputs_flat = x.reshape(n * f, dof)
        bn_mask = LS.mask_from_seq_lengths(seq_lengths, f).reshape(n * f)

        def to_single_shape(s):
            return _average_over_frames(s.reshape(n, f, -1)).reshape(n * f, -1)

        new_carry = None
        with span("lgd.init"):
            if self.rnn_init:
                lstm_out, new_carry = self.rnn(x, seq_lengths, carry, generator)
                pose_hat = self.pose_net_init(lstm_out).reshape(n * f, -1)
                shape_hat = self.shape_net_init(lstm_out).reshape(n * f, -1)
            else:
                pose_hat = self.pose_net_init(inputs_flat, bn_mask, generator)
                shape_hat = self.shape_net_init(inputs_flat, bn_mask, generator)
            if self.shape_avg:
                shape_hat = to_single_shape(shape_hat)

        hist = {"pose": [], "shape": [], "joints": [], "marker_pos": [], "marker_ori": []}

        def fk_and_record(pose, shape):
            with span("lgd.fk"):
                if getattr(self.config, "remat", False):
                    mp, mo, joints = checkpoint(self.smpl.estimated_markers, pose, shape,
                                                offset_r, offset_t, use_reentrant=False,
                                                preserve_rng_state=False)
                else:
                    mp, mo, joints = self.smpl.estimated_markers(pose, shape, offset_r, offset_t)
                hist["pose"].append(pose)
                hist["shape"].append(shape)
                hist["joints"].append(joints.reshape(n * f, -1))
                hist["marker_pos"].append(mp.reshape(n * f, -1))
                hist["marker_ori"].append(mo.reshape(n * f, -1))
            return mp, mo

        mp, mo = fk_and_record(pose_hat, shape_hat)
        recon_for_grad = []
        scale = float(n * f)
        for i in range(self.N):
            inputs_step = [inputs_flat, hist["pose"][-1].detach(), hist["shape"][-1].detach()]
            if self.use_gradient:
                with span("lgd.grad"):
                    recon = self._recon_error(inputs_flat, mp, mo, n, f, seq_lengths,
                                              marker_masks)
                    g_pose, g_shape = torch.autograd.grad(recon, (pose_hat, shape_hat),
                                                          retain_graph=True)
                    recon_for_grad.append(recon)
                    inputs_step += [g_pose * scale, g_shape * scale]
            with span("lgd.mlp"):
                iter_in = torch.cat(inputs_step, dim=-1)
                pose_delta = self.pose_net_iter(iter_in, bn_mask, generator)
                shape_delta = self.shape_net_iter(iter_in, bn_mask, generator)
                if self.shape_avg:
                    shape_delta = to_single_shape(shape_delta)
                pose_hat = hist["pose"][-1] + pose_delta * self.step_size
                shape_hat = hist["shape"][-1] + shape_delta * self.step_size
            mp, mo = fk_and_record(pose_hat, shape_hat)

        history = {k: torch.stack([h.reshape(n, f, -1) for h in v]) for k, v in hist.items()}
        pose_final = history["pose"][-1]
        out = {
            "pose_hat": pose_final[:, :, 3:],
            "root_ori_hat": pose_final[:, :, :3],
            "shape_hat": history["shape"][-1],
            "joints_hat": history["joints"][-1],
            "history": history,
            "_recon_for_grad": recon_for_grad,
        }
        return out, new_carry

    def compute_loss(self, batch: Dict, out: Dict):
        """L1 pose/shape + FK + reconstruction losses summed over all N+1
        history steps, normalized by the history length
        (``IterativeErrorFeedback.compute_loss``). Kept quirk: the FK term
        reads the FINAL joints for every history step.

        :return: (total, {pose, shape, reconstruction, fk, total_loss}).
        """
        poses = batch["poses"]
        n, f = poses.shape[0], poses.shape[1]
        seq_lengths = batch["seq_lengths"]
        marker_masks = batch.get("marker_masks")
        hist = out["history"]
        n_hist = hist["pose"].shape[0]
        inputs_ = self.prepare_inputs(batch)
        markers_in = inputs_[:, :, self.pos_d_start:self.pos_d_end].reshape(n, f, -1, 3)
        markers_ori_in = inputs_[:, :, self.ori_d_start:self.ori_d_end].reshape(n, f, -1, 9)
        sel = self.marker_sel
        shapes_rep = batch["shapes"][:, None].expand(n, f, batch["shapes"].shape[-1])

        zero = poses.new_zeros(())
        pose_loss, shape_loss, recon_loss, fk_loss = zero, zero, zero, zero
        for i in range(n_hist):
            pose_loss = pose_loss + LS.padded_loss(poses, hist["pose"][i], LS.l1, seq_lengths)
            shape_loss = shape_loss + LS.padded_loss(shapes_rep, hist["shape"][i], LS.l1, seq_lengths)
            if self.do_fk:
                joints_gt = batch["joints_gt"].reshape(n, f, -1, 3)
                joints_hat = out["joints_hat"].reshape(n, f, -1, 3)
                fk_loss = fk_loss + LS.reconstruction_loss(joints_gt, joints_hat, seq_lengths,
                                                           marker_masks)
            if self.config.use_marker_pos:
                mh = hist["marker_pos"][i].reshape(n, f, -1, 3).index_select(2, sel)
                recon_loss = recon_loss + LS.reconstruction_loss(markers_in, mh, seq_lengths,
                                                                 marker_masks)
            if self.config.use_marker_ori:
                moh = hist["marker_ori"][i].reshape(n, f, -1, 9).index_select(2, sel)
                recon_loss = recon_loss + LS.reconstruction_loss(markers_ori_in, moh, seq_lengths,
                                                                 marker_masks)

        total = (self.pose_weight * pose_loss + self.fk_loss_weight * fk_loss
                 + self.shape_weight * shape_loss + self.r_weight * recon_loss) / n_hist
        vals = {"pose": pose_loss / n_hist, "shape": shape_loss / n_hist,
                "reconstruction": recon_loss / n_hist, "fk": fk_loss / n_hist,
                "total_loss": total}
        return total, vals

    def reference_grad_extra_loss(self, out: Dict) -> torch.Tensor:
        """Value-zero term reproducing the reference's parameter-gradient
        quirk: its forward calls ``reconstruction_error.backward()`` once per
        refinement step, depositing extra gradients on top of the main loss.
        ``sum_i(recon_i - recon_i.detach())`` adds those gradients without
        changing the loss value."""
        extra = out["history"]["pose"].new_zeros(())
        if not self.use_gradient:
            return extra
        for term in out.get("_recon_for_grad", []):
            extra = extra + (term - term.detach())
        return extra
