"""Real-data evaluation: windowed streaming eval, the metric passes and the
visualization export (port of ``empose_tpu/eval/harness.py``).

Three passes give the per-sequence rows and the 'Overall average' row of
``scripts/evaluate_real.py`` (MPJPE, PA-MPJPE, MPJAE with their stds):

* batched (the default): the sequences stacked on the batch axis, padded to
  a common frame count, each window's forward run for all of them at once
  with the LSTM carry threaded from window to window, then one metric
  update over all N*F rows with per-sequence statistics and one copy to the
  host. Sequences go into groups in length order (:func:`build_eval_corpus`):
  one group per padded length when each runs as one window, and a new group
  wherever the padded arrays would exceed ``EVAL_CORPUS_BYTES``. A
  sequence's results do not depend on the grouping, and equal the serial
  loop's. (The JAX package pads every sequence of a whole-sequence pass to
  the corpus's longest, which moves a frame-averaged shape estimate; the
  port pads each as the serial loop does.);
* serial: one sequence at a time, window by window, statistics on the
  device and one copy per sequence (``--serial``, and ``--visualize``,
  which needs the predicted poses);
* host oracle: the same window loop with the errors copied to the host
  and aggregated by ``MetricsEngine`` (``--host_metrics``).

Every pass normalizes the root per sequence before cutting windows, freezes
the shape estimate of a model that has one at its first window, and counts
a frame as valid when it lies inside the sequence and no marker of it is
masked. The model runs on its device under ``torch.no_grad()``; an LSTM
runs through the inference kernels there (the stack kernel for a
unidirectional one, the bidirectional layer kernel for a BiRNN).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import SMPLHModel, SMPLLayer, load_smplh, smplh_fk
from empose_tpu_torch.data.batches import (TIME_KEYS, collate_amass, collate_real, slice_window,
                                           to_device)
from empose_tpu_torch.data.datasets import EMRSequenceDataset, Loader, RealDataset
from empose_tpu_torch.data.transforms import normalize_root
from empose_tpu_torch.eval.metrics import (METRIC_NAMES, MetricsEngine, body_model, format_table,
                                           metric_stats_init, metric_stats_merge,
                                           metric_stats_reduce, metric_stats_select,
                                           metric_stats_update,
                                           metrics_from_stats, stats_to_host)
from empose_tpu_torch.utils.experiments import load_model

VIS_CHUNK = 512  # frames per full-mesh FK call
# Bytes of padded corpus arrays that one batched pass holds; a larger corpus
# is evaluated in groups of sequences.
EVAL_CORPUS_BYTES = 256 << 20
# Keys of a real batch that the forward reads per window; the rest is per sequence.
INPUT_KEYS = ("marker_pos", "marker_ori", "marker_nor", "marker_masks")
STATIC_KEYS = ("shapes", "offset_t", "offset_r")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_time(batch: Dict, target_f: int) -> Dict:
    """Right-pad the time-major arrays of a host batch to ``target_f`` frames."""
    out = {}
    for k, v in batch.items():
        if k in TIME_KEYS and v.shape[1] < target_f:
            pad = [(0, 0)] * v.ndim
            pad[1] = (0, target_f - v.shape[1])
            v = np.pad(np.asarray(v), pad)
        out[k] = v
    return out


def window_generator(batch: Dict, window_size: Optional[int]) -> Iterator[Tuple[Dict, int]]:
    """Cut a host batch into windows of ``window_size`` frames, the last one
    padded; yields (window, frames of the batch in it). ``seq_lengths`` are
    clipped into each window; ``None`` yields the batch whole."""
    seq_len = batch["poses"].shape[1]
    if window_size is None:
        yield batch, seq_len
        return
    for sf in range(0, seq_len, window_size):
        ef = min(sf + window_size, seq_len)
        yield pad_time(slice_window(batch, sf, ef), window_size), ef - sf


def preprocess_real_chunk(body: SMPLHModel, chunk: Dict) -> Dict:
    """The ground-truth joints (N, F, 66) of a real window on the device:
    FK of its poses, shapes and translations over the body subtree."""
    poses = chunk["poses"]
    n, f = poses.shape[0], poses.shape[1]
    flat = poses.reshape(n * f, -1)
    _, joints = smplh_fk(body, flat[:, 3:], chunk["shapes"].repeat_interleave(f, dim=0),
                         poses_root=flat[:, :3], trans=chunk["trans"].reshape(n * f, 3),
                         want_vertices=False)
    out = dict(chunk)
    out["joints_gt"] = joints.reshape(n, f, -1)
    return out


class EvalSession:
    """One model's eval steps on its device, each in eval mode.

    :param model: a port model in eval mode (``utils.experiments.load_model``).
    :param smplh: the SMPL-H model (host arrays): the metrics' and the
      ground truth's FK, and the mesh of the visualization export.
    """

    def __init__(self, model, smplh: SMPLHModel):
        self.model = model
        self.device = next(model.parameters()).device
        self.smplh = smplh
        self.body = body_model(smplh, self.device)
        self._layer = None

    def layer(self) -> SMPLLayer:
        """The full-mesh layer of the visualization export, built at first use."""
        if self._layer is None:
            self._layer = SMPLLayer(self.smplh, self.device)
        return self._layer

    def normalized(self, batch: Dict) -> Dict:
        """The batch with its root normalized per sequence (frame-0 root
        orientation the identity, zero translation), as host arrays."""
        with torch.no_grad():
            normed = normalize_root(to_device(batch, self.device))
        out = {k: normed[k].cpu().numpy() if k in normed else v for k, v in batch.items()}
        out["seq_lengths"] = np.asarray(batch["seq_lengths"], np.int32)
        return out

    def forward_chunk(self, chunk: Dict, carry):
        """One window: (outputs {root_ori_hat, pose_hat[, shape_hat]}, loss
        values, carry), tensors on the device."""
        self.model.eval()
        with torch.no_grad():
            batch = preprocess_real_chunk(self.body, to_device(chunk, self.device))
            out, new_carry = self.model(batch, carry)
            _, vals = self.model.compute_loss(batch, out)
        slim = {k: out[k] for k in ("root_ori_hat", "pose_hat", "shape_hat")
                if out.get(k) is not None}
        return slim, vals, new_carry

    def forward_chunk_stats(self, chunk: Dict, carry, stats: Dict, frozen, is_first: bool,
                            with_losses: bool = False):
        """One window with the metric update on the device, no host copy:
        (outputs, loss values or None, stats, frozen shape, carry). The shape
        estimate is frozen at the first window. The loss values
        (``with_losses``) cost one FK more, of the ground-truth joints."""
        self.model.eval()
        with torch.no_grad():
            batch = to_device(chunk, self.device)
            if with_losses:
                batch = preprocess_real_chunk(self.body, batch)
            out, new_carry = self.model(batch, carry)
            vals = self.model.compute_loss(batch, out)[1] if with_losses else None
            shape_hat = out.get("shape_hat")
            if shape_hat is not None and is_first:
                frozen = shape_hat[:, 0]
            stats = metric_stats_update(
                self.body, stats, pose=batch["poses"][:, :, 3:], shape=batch["shapes"],
                pose_hat=out["pose_hat"], shape_hat=frozen if shape_hat is not None else None,
                seq_lengths=batch["seq_lengths"], pose_root=batch["poses"][:, :, :3],
                pose_root_hat=out["root_ori_hat"], frame_mask=batch.get("marker_masks"))
        return out, vals, stats, frozen, new_carry

    def run_pass(self, batch: Dict, window: int):
        """A whole batched pass over stacked sequences (host arrays, frames a
        multiple of ``window``): root normalization, the windowed forward
        with the carry threaded from window to window (no carry at the
        first: a zero state for every model), then one metric update over
        all N*F rows. :return: (per-sequence stats on the device, frozen
        shape or None)."""
        self.model.eval()
        with torch.no_grad():
            b = normalize_root(to_device(batch, self.device))
            n, f = b["poses"].shape[0], b["poses"].shape[1]
            lengths = b["seq_lengths"]
            carry, frozen, poses_hat = None, None, []
            for start in range(0, f, window):
                chunk = {k: b[k] for k in STATIC_KEYS if k in b}
                chunk.update({k: b[k][:, start:start + window] for k in INPUT_KEYS if k in b})
                chunk["seq_lengths"] = (lengths - start).clamp(0, window)
                out, carry = self.model(chunk, carry)
                poses_hat.append(torch.cat([out["root_ori_hat"], out["pose_hat"]], -1))
                if start == 0 and out.get("shape_hat") is not None:
                    frozen = out["shape_hat"][:, 0]
            pose_hat = torch.cat(poses_hat, 1)
            stats = metric_stats_update(
                self.body, metric_stats_init(n, self.device), pose=b["poses"][:, :, 3:],
                shape=b["shapes"], pose_hat=pose_hat[:, :, 3:], shape_hat=frozen,
                seq_lengths=lengths, pose_root=b["poses"][:, :, :3],
                pose_root_hat=pose_hat[:, :, :3], frame_mask=b.get("marker_masks"),
                per_sample=True)
        return stats, frozen


def _select_sample(batch: Dict, j: int) -> Dict:
    """Sequence ``j`` of a collated batch, batch axis kept."""
    return {k: ([v[j]] if k == "ids" else np.asarray(v)[j:j + 1] if hasattr(v, "shape") else v)
            for k, v in batch.items()}


def _metric_row(name, metrics: Dict[str, float]) -> list:
    return [name] + [metrics[k] for k in METRIC_NAMES]


def evaluate_real_sequences(session: EvalSession, loader, window_size: Optional[int],
                            pad_multiple: int = 256, visualize_index: int = -1,
                            visualize_dir: Optional[str] = None, host_metrics: bool = False,
                            serial: bool = False):
    """Per-sequence rows and the 'Overall average' row.

    :param window_size: frames per window, or None: each sequence in one
      window, padded to a multiple of ``pad_multiple``.
    :param visualize_index: >= 0: export the predicted and ground-truth
      meshes of that sequence (:func:`export_visualization`); runs serially.
    :return: (rows [[id, MPJPE, MPJPE STD, PA-MPJPE, PA-MPJPE STD, MPJAE,
      MPJAE STD], ..., ["Overall average", ...]], overall metric dict)
    """
    if host_metrics:
        return _evaluate_host(session, loader, window_size, pad_multiple, visualize_index,
                              visualize_dir)
    if serial or visualize_index >= 0:
        return _evaluate_serial(session, loader, window_size, pad_multiple, visualize_index,
                                visualize_dir)
    return _evaluate_batched(session, loader, window_size, pad_multiple)


def build_eval_corpus(loader, window_size: Optional[int], pad_multiple: int = 256):
    """Every sequence of ``loader``, stacked into groups for
    :meth:`EvalSession.run_pass`, in length order.

    Each sequence runs with the frames the serial loop gives it: its own
    rounded up to the window, or without one to ``pad_multiple`` (its one
    window). Without a window a group holds sequences of one such length,
    since a frame-averaged shape estimate averages over the padding; with
    one a group pads to its longest sequence, as the windows beyond a
    sequence's end are fully masked and change none of its results. A group
    closes where its padded arrays would exceed ``EVAL_CORPUS_BYTES`` (it
    keeps at least one sequence).

    :return: (ids, true lengths, [(positions in ids, stacked host dict,
      window), ...]), or None for an empty loader.
    """
    seqs = [_select_sample(batch, j) for batch in loader for j in range(len(batch["ids"]))]
    if not seqs:
        return None
    ids = [s["ids"][0] for s in seqs]
    lengths = [int(s["seq_lengths"][0]) for s in seqs]
    frames = [_round_up(s["poses"].shape[1], window_size or pad_multiple) for s in seqs]
    frame_bytes = sum(v.nbytes // v.shape[1] for k, v in seqs[0].items() if k in TIME_KEYS)
    groups: List[List[int]] = []
    for i in sorted(range(len(seqs)), key=lambda i: (frames[i], i)):
        g = groups[-1] if groups else None
        if g is None or (window_size is None and frames[i] != frames[g[0]]) \
                or (len(g) + 1) * frames[i] * frame_bytes > EVAL_CORPUS_BYTES:
            groups.append([i])
        else:
            g.append(i)
    out = []
    for members in groups:
        f = frames[members[-1]]
        padded = [pad_time(seqs[i], f) for i in members]
        stacked = {k: np.concatenate([np.asarray(p[k]) for p in padded])
                   for k in padded[0] if k != "ids"}
        out.append((members, stacked, window_size or f))
    return ids, lengths, out


def _evaluate_batched(session: EvalSession, loader, window_size, pad_multiple):
    corpus = build_eval_corpus(loader, window_size, pad_multiple)
    if corpus is None:
        overall = metrics_from_stats(metric_stats_init())
        return [_metric_row("Overall average", overall)], overall
    ids, lengths, groups = corpus
    for sid, n in zip(ids, lengths):
        print(f"Evaluate {sid} ({n} frames)")
    per_seq: List[Optional[Dict]] = [None] * len(ids)
    for members, stacked, window in groups:
        stats = stats_to_host(session.run_pass(stacked, window)[0])  # the group's one copy
        for row, i in enumerate(members):
            per_seq[i] = metric_stats_select(stats, row)
    rows = [_metric_row(sid, metrics_from_stats(st)) for sid, st in zip(ids, per_seq)]
    overall = metrics_from_stats(metric_stats_reduce(
        {k: np.stack([st[k] for st in per_seq]) for k in per_seq[0]}))
    rows.append(_metric_row("Overall average", overall))
    return rows, overall


def _sequence_batch(session: EvalSession, batch: Dict, window_size, pad_multiple) -> Dict:
    """One sequence, its root normalized; padded to a multiple of
    ``pad_multiple`` where it runs as one window."""
    print(f"Evaluate {batch['ids'][0]} ({int(batch['seq_lengths'][0])} frames)")
    host = session.normalized(batch)
    if window_size is None:
        host = pad_time(host, _round_up(host["poses"].shape[1], pad_multiple))
    return host


def _export(session: EvalSession, seq_id, host_batch, pose_chunks, shape_hat, visualize_dir):
    export_visualization(session.layer(), seq_id, host_batch, np.concatenate(pose_chunks, 0),
                         shape_hat, visualize_dir or "visualize")


def serial_pass(session: EvalSession, loader, window_size: Optional[int],
                pad_multiple: int = 256, with_losses: bool = False, visualize_index: int = -1,
                visualize_dir: Optional[str] = None) -> List[Tuple]:
    """The serial loop: one loader batch (one sequence in the eval CLI's
    loaders) at a time, window by window from the model's initial carry,
    the metric statistics on the device and one copy per batch.

    :param with_losses: also the model's loss values of each window.
    :return: [(first id, host statistics, loss values averaged over the
      windows (device scalars) or None, batch size), ...] in loader order.
    """
    out = []
    for seq_idx, batch in enumerate(loader):
        host = _sequence_batch(session, batch, window_size, pad_multiple)
        carry, frozen, pose_chunks, chunk_vals = session.model.initial_carry(), None, [], []
        stats = metric_stats_init(device=session.device)
        for c, (chunk, _) in enumerate(window_generator(host, window_size)):
            pred, vals, stats, frozen, carry = session.forward_chunk_stats(
                chunk, carry, stats, frozen, c == 0, with_losses)
            chunk_vals.append(vals)
            if seq_idx == visualize_index:
                pose_chunks.append(torch.cat([pred["root_ori_hat"][0], pred["pose_hat"][0]],
                                             -1).cpu().numpy())
        if seq_idx == visualize_index:
            _export(session, batch["ids"][0], host, pose_chunks,
                    None if frozen is None else frozen[0].cpu().numpy(), visualize_dir)
        losses = ({k: torch.stack([v[k] for v in chunk_vals]).mean() for k in chunk_vals[0]}
                  if with_losses else None)
        out.append((batch["ids"][0], stats_to_host(stats), losses, len(batch["ids"])))
    return out


def merge_stats(stats: List[Dict]) -> Dict:
    """The float64 merge of host statistics (empty: the empty statistics)."""
    total = metric_stats_init()
    for st in stats:
        total = metric_stats_merge(total, st)
    return total


def _evaluate_serial(session: EvalSession, loader, window_size, pad_multiple,
                     visualize_index=-1, visualize_dir=None):
    seqs = serial_pass(session, loader, window_size, pad_multiple,
                       visualize_index=visualize_index, visualize_dir=visualize_dir)
    rows = [_metric_row(sid, metrics_from_stats(st)) for sid, st, _, _ in seqs]
    overall = metrics_from_stats(merge_stats([st for _, st, _, _ in seqs]))
    rows.append(_metric_row("Overall average", overall))
    return rows, overall


def _evaluate_host(session: EvalSession, loader, window_size, pad_multiple,
                   visualize_index=-1, visualize_dir=None):
    me_all = MetricsEngine(session.smplh, session.device)
    me_ind = MetricsEngine(session.smplh, session.device)
    rows = []
    for seq_idx, batch in enumerate(loader):
        host = _sequence_batch(session, batch, window_size, pad_multiple)
        me_ind.reset()
        carry, first_shape, pose_chunks = session.model.initial_carry(), None, []
        for c, (chunk, _) in enumerate(window_generator(host, window_size)):
            out, _, carry = session.forward_chunk(chunk, carry)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if c == 0 and "shape_hat" in out:
                first_shape = out["shape_hat"][:, 0]
            if seq_idx == visualize_index:
                pose_chunks.append(np.concatenate([out["root_ori_hat"][0], out["pose_hat"][0]], -1))
            args = dict(pose=chunk["poses"][:, :, 3:], shape=chunk["shapes"],
                        pose_hat=out["pose_hat"], shape_hat=first_shape,
                        seq_lengths=chunk["seq_lengths"], pose_root=chunk["poses"][:, :, :3],
                        pose_root_hat=out["root_ori_hat"], frame_mask=chunk["marker_masks"])
            me_all.compute(**args)
            me_ind.compute(**args)
        if seq_idx == visualize_index:
            _export(session, batch["ids"][0], host, pose_chunks,
                    None if first_shape is None else first_shape[0], visualize_dir)
        rows.append(_metric_row(batch["ids"][0], me_ind.get_metrics()))
    overall = me_all.get_metrics()
    rows.append(_metric_row("Overall average", overall))
    return rows, overall


def print_metric_table(rows, model_id) -> str:
    """Print (and return) the numbered table of metric rows."""
    s = format_table(["Nr", f"E2E {model_id}"] + list(METRIC_NAMES),
                     [[i] + list(r) for i, r in enumerate(rows)])
    print(s)
    return s


def load_model_and_eval_data(model_id, partition: str = "test_real",
                             batch_size: Optional[int] = None,
                             experiment_dir: Optional[str] = None, device=None):
    """A model's eval session and the loader of a partition: 'valid' (the
    3DPW corpus of $EM_DATA_SYNTH, middle windows of the model's window
    size), 'test_real' (the recordings of $EM_DATA_REAL) or
    'test_real_0715' (its ``hold_out`` subject).

    :param device: None = CUDA (raises without it); ``"cpu"`` for tests.
    :return: (EvalSession, loader, config)
    """
    if partition not in ("valid", "test_real", "test_real_0715"):
        raise ValueError(f"unknown partition {partition!r}")
    model, config, _ = load_model(model_id, experiment_dir, device)
    session = EvalSession(model, load_smplh())
    if partition == "valid":
        ds = EMRSequenceDataset(os.path.join(C.data_dir_synth(), "3dpw_emr"),
                                window_size=config.window_size, window_mode="middle")
        return session, Loader(ds, batch_size or 6, collate_amass, shuffle=False), config
    data_dir = C.data_dir_real()
    if partition == "test_real_0715":
        data_dir = os.path.join(data_dir, "hold_out")
    return session, Loader(RealDataset(data_dir), batch_size or 1, collate_real,
                           shuffle=False), config


def _write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {a} {b} {c}\n")


def export_visualization(smpl, seq_id: str, host_batch: Dict, pose_full_hat: np.ndarray,
                         shape_hat: Optional[np.ndarray], out_dir: str, device=None) -> str:
    """Dump predicted-vs-GT skeleton and mesh artifacts for one sequence.

    The full-mesh FK runs in chunks of 512 frames through ``SMPLLayer.fk``,
    so the skinning goes through the LBS kernel on the card.

    :param smpl: an ``SMPLLayer``, or an object whose ``full`` is a full-mesh
      ``SMPLHModel`` (then a layer is built on ``device``).
    :param host_batch: numpy batch of one sequence (``seq_lengths``,
      ``poses`` (1, F, 66), ``shapes`` (1, 10)).
    :param pose_full_hat: (F, 66) predicted root+body pose (angle-axis).
    :param shape_hat: (10,) predicted betas or None (GT betas reused).
    :return: path of the written npz (beside it ``<seq_id>_frame0_gt.obj``
      and ``<seq_id>_frame0_pred.obj``).
    """
    layer = smpl if isinstance(smpl, SMPLLayer) else SMPLLayer(smpl.full, device)
    os.makedirs(out_dir, exist_ok=True)
    true_len = int(np.asarray(host_batch["seq_lengths"])[0])
    poses_gt = np.asarray(host_batch["poses"])[0, :true_len]
    shape_gt = np.asarray(host_batch["shapes"])[0]
    pose_hat = np.asarray(pose_full_hat)[:true_len]
    betas_hat = shape_gt if shape_hat is None else np.asarray(shape_hat).reshape(-1)

    def fk(poses, betas):
        vs, js = [], []
        with torch.no_grad():
            for s in range(0, poses.shape[0], VIS_CHUNK):
                p = np.asarray(poses[s:s + VIS_CHUNK], np.float32)
                v, j = layer.fk(p[:, 3:], np.asarray(betas, np.float32)[None], poses_root=p[:, :3])
                vs.append(v.cpu().numpy())
                js.append(j[:, : C.N_JOINTS + 1].cpu().numpy())
        return np.concatenate(vs), np.concatenate(js)

    verts_gt, joints_gt = fk(poses_gt, shape_gt)
    verts_hat, joints_hat = fk(pose_hat, betas_hat)
    faces = np.asarray(layer.faces)

    npz_path = os.path.join(out_dir, f"{seq_id}.npz")
    np.savez_compressed(
        npz_path, joints_gt=joints_gt, joints_hat=joints_hat,
        verts_gt=verts_gt, verts_hat=verts_hat, faces=faces,
        poses_gt=poses_gt, pose_hat=pose_hat, shape_gt=shape_gt, shape_hat=betas_hat,
        parents=np.asarray(C.SMPL_PARENTS[: C.N_JOINTS + 1]))
    _write_obj(os.path.join(out_dir, f"{seq_id}_frame0_gt.obj"), verts_gt[0], faces)
    _write_obj(os.path.join(out_dir, f"{seq_id}_frame0_pred.obj"), verts_hat[0], faces)
    print(f"Visualization artifacts written to {out_dir}")
    return npz_path
