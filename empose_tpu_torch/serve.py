"""Streaming inference on the card: live sensor feeds in, poses out.

Port of ``empose_tpu/serve.py`` (``StreamingPredictor``,
``MultiStreamPredictor``) with the same push/flush/reset/step semantics:
frames are buffered into fixed ``chunk_size`` windows, each stream keeps its
own LSTM carry, mounting offsets and frozen shape estimate, and a tail is
padded by repeating its last frame (the per-window shape average reads every
frame). ``MultiStreamPredictor`` serves every ready stream in one batched
forward; idle streams run with length 0 and their carry is left unchanged by
the kernel's mask freeze.

CLI (JSON lines over stdin/stdout, the protocol of ``scripts/serve.py``)::

    python -m empose_tpu_torch.serve --model_id <id> [--chunk 16] [--streams N]
        [--dp_devices D] [--precision highest|high|default] [--device cuda|cpu] < frames.jsonl

``--dp_devices D`` (with ``--streams`` > 1, divisible by D) splits the
streams over D devices, a replica of the model on each
(``MultiStreamPredictor(mesh=...)``), as ``scripts/serve.py`` does.

``--precision`` binds the NN and the kinematics matmul precision together,
as ``scripts/serve.py`` does (``device.set_precision``): ``highest`` is the
fp32 parity mode, ``high`` the bf16_3x product, ``default`` the bf16 serving
mode (bf16 inputs, f32 sums; the LSTM kernels on the tensor cores). The
predictors run at the knobs' mode.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch.device import set_precision
from empose_tpu_torch.parallel.mesh import make_mesh
from empose_tpu_torch.utils.precision import PRECISIONS
from empose_tpu_torch.utils.profiling import span


def _forward(model, pos_d: int, pos_ori: np.ndarray, lengths: np.ndarray, offset_t, offset_r,
             carry):
    """One batched forward, issued: ONE upload (pos|ori); returns the packed
    outputs (root|pose[|shape]) on the device, their widths and the carry."""
    dev = offset_t.device
    with span("serve.upload"):
        x = torch.from_numpy(pos_ori).to(dev)
        seq_lengths = torch.from_numpy(lengths).to(dev)
    window = {
        "marker_pos": x[..., :pos_d],
        "marker_ori": x[..., pos_d:],
        "seq_lengths": seq_lengths,
        "offset_t": offset_t,
        "offset_r": offset_r,
    }
    with span("serve.forward"), torch.no_grad():
        out, new_carry = model(window, carry)
        parts = [out["root_ori_hat"], out["pose_hat"]]
        if out.get("shape_hat") is not None:
            parts.append(out["shape_hat"])
        packed = torch.cat(parts, dim=-1)
    widths = (out["root_ori_hat"].shape[-1], out["pose_hat"].shape[-1])
    return packed, widths, new_carry


def _run(model, pos_d: int, pos_ori: np.ndarray, lengths: np.ndarray, offset_t, offset_r, carry):
    """One batched forward: ONE upload (pos|ori), ONE download (root|pose[|shape])."""
    packed, widths, new_carry = _forward(model, pos_d, pos_ori, lengths, offset_t, offset_r,
                                         carry)
    return packed.cpu().numpy(), widths, new_carry


def _unpack_rows(widths, rows: np.ndarray) -> Dict[str, np.ndarray]:
    r, p = widths
    out = {"root_ori": rows[:, :r], "pose_body": rows[:, r:r + p]}
    if rows.shape[-1] > r + p:
        out["shape"] = rows[:, r + p:]
    return out


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class StreamingPredictor:
    """One live session: ``push`` frames, get poses per completed chunk."""

    def __init__(self, model, chunk_size: int = 16, offset_t: Optional[np.ndarray] = None,
                 offset_r: Optional[np.ndarray] = None, n_raw_markers: int = 12):
        """:param model: an eval-mode model on its device (``load_model``).
        :param offset_t/offset_r: mounting offsets (M, 3)/(M, 3, 3); zero /
          identity when unknown."""
        self.model = model
        self.chunk = chunk_size
        self.m = n_raw_markers
        self.device = _model_device(model)
        self.offset_t = np.zeros((self.m, 3), np.float32) if offset_t is None else offset_t
        self.offset_r = np.broadcast_to(np.eye(3, dtype=np.float32), (self.m, 3, 3)) \
            if offset_r is None else offset_r
        self.reset()

    @property
    def offset_t(self) -> np.ndarray:
        return self._offset_t

    @offset_t.setter
    def offset_t(self, value) -> None:
        self._offset_t = np.asarray(value, np.float32).reshape(1, self.m, 3)
        self._offset_t_dev = torch.from_numpy(self._offset_t.copy()).to(self.device)

    @property
    def offset_r(self) -> np.ndarray:
        return self._offset_r

    @offset_r.setter
    def offset_r(self, value) -> None:
        self._offset_r = np.asarray(value, np.float32).reshape(1, self.m, 3, 3)
        self._offset_r_dev = torch.from_numpy(self._offset_r.copy()).to(self.device)

    @classmethod
    def from_experiment(cls, model_id, chunk_size: int = 16, device=None, **kw) -> "StreamingPredictor":
        from empose_tpu_torch.utils.experiments import load_model
        model, _, _ = load_model(model_id, device=device)
        return cls(model, chunk_size, **kw)

    def reset(self) -> None:
        """Start a new sequence."""
        self.carry = self.model.initial_carry()
        self._buf_pos: list = []
        self._buf_ori: list = []
        self.first_shape: Optional[np.ndarray] = None

    def _infer_chunk(self, pos: np.ndarray, ori: np.ndarray, n_valid: int):
        pos_ori = np.concatenate([pos, ori], axis=-1)[None]
        packed, widths, self.carry = _run(self.model, self.m * 3, pos_ori,
                                          np.asarray([n_valid], np.int64),
                                          self._offset_t_dev, self._offset_r_dev, self.carry)
        out = _unpack_rows(widths, packed[0, :n_valid])
        if "shape" in out:
            if self.first_shape is None:
                # Frozen to the first chunk's estimate (reference streaming eval).
                self.first_shape = out["shape"][0]
            out["shape"] = np.broadcast_to(self.first_shape, out["shape"].shape)
        return out

    def push(self, marker_pos: np.ndarray, marker_ori: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
        """Feed frames ((K, M*3), (K, M*9)); returns outputs for each
        completed chunk, or None."""
        self._buf_pos.extend(np.asarray(marker_pos, np.float32).reshape(-1, self.m * 3))
        self._buf_ori.extend(np.asarray(marker_ori, np.float32).reshape(-1, self.m * 9))
        outs = []
        while len(self._buf_pos) >= self.chunk:
            pos = np.stack(self._buf_pos[: self.chunk])
            ori = np.stack(self._buf_ori[: self.chunk])
            del self._buf_pos[: self.chunk]
            del self._buf_ori[: self.chunk]
            outs.append(self._infer_chunk(pos, ori, self.chunk))
        if not outs:
            return None
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        """Drain buffered frames, padded to the chunk by repeating the last one."""
        n = len(self._buf_pos)
        if n == 0:
            return None
        pos = np.stack(self._buf_pos + [self._buf_pos[-1]] * (self.chunk - n))
        ori = np.stack(self._buf_ori + [self._buf_ori[-1]] * (self.chunk - n))
        self._buf_pos.clear()
        self._buf_ori.clear()
        return self._infer_chunk(pos, ori, n)


class MultiStreamPredictor:
    """Many independent sessions served by ONE batched forward per ``step``.

    Streams with a full chunk buffered (or listed for flushing) contribute
    it; all others run with ``seq_lengths=0`` and keep their state.

    With ``mesh`` (a list of devices, ``parallel.mesh.make_mesh``) the
    stream axis is split into one contiguous shard per device, each served
    by a replica of the model on its device (the model itself where the
    device is its own) with its own carry and offsets: a step issues every
    shard's upload and forward before the first download. ``n_streams``
    must be divisible by the number of devices (streams are live sessions
    and are not padded). Every shard runs the LSTM kernels, whatever its
    row count (the port has no per-device batch gate).
    """

    def __init__(self, model, n_streams: int, chunk_size: int = 16, n_raw_markers: int = 12,
                 mesh=None):
        self.model = model
        self.S = n_streams
        self.chunk = chunk_size
        self.m = n_raw_markers
        self.device = _model_device(model)
        devices = [self.device] if mesh is None else [torch.device(d) for d in mesh]
        if n_streams % len(devices):
            raise ValueError(f"n_streams={n_streams} must be divisible by the mesh size "
                             f"{len(devices)} (streams are live sessions and cannot be "
                             "wrap-around padded)")
        self.per_shard = n_streams // len(devices)
        self.replicas = [model if d == self.device else copy.deepcopy(model).to(d)
                         for d in devices]
        self._offset_t = np.zeros((n_streams, self.m, 3), np.float32)
        self._offset_r = np.broadcast_to(np.eye(3, dtype=np.float32),
                                         (n_streams, self.m, 3, 3)).copy()
        self._offsets_dirty = True
        self._carries = [r.initial_carry() for r in self.replicas]
        self._bufs = [([], []) for _ in range(n_streams)]
        self._first_shape: list = [None] * n_streams

    @property
    def carry(self):
        """The LSTM carry of every stream ((L, S, H) pairs; None where the
        model keeps none), the shards' joined on the first device."""
        if len(self._carries) == 1 or self._carries[0] is None:
            return self._carries[0]
        dev = self._carries[0][0].device
        return tuple(torch.cat([c[k].to(dev) for c in self._carries], dim=1) for k in range(2))

    def _shard(self, i: int) -> tuple:
        return divmod(i, self.per_shard)

    @classmethod
    def from_experiment(cls, model_id, n_streams: int, chunk_size: int = 16, device=None,
                        **kw) -> "MultiStreamPredictor":
        from empose_tpu_torch.utils.experiments import load_model
        model, _, _ = load_model(model_id, device=device)
        return cls(model, n_streams, chunk_size, **kw)

    def set_offsets(self, i: int, offset_t: np.ndarray, offset_r: np.ndarray) -> None:
        """Mounting offsets for stream ``i`` ((M, 3), (M, 3, 3))."""
        self._offset_t[i] = np.asarray(offset_t, np.float32)
        self._offset_r[i] = np.asarray(offset_r, np.float32)
        self._offsets_dirty = True

    def reset(self, i: int) -> None:
        """Start a new sequence on stream ``i``; zeroes its column of its
        shard's carry."""
        self._bufs[i] = ([], [])
        self._first_shape[i] = None
        s, row = self._shard(i)
        if self._carries[s] is not None:
            h, c = (a.clone() for a in self._carries[s])
            h[:, row] = 0.0
            c[:, row] = 0.0
            self._carries[s] = (h, c)

    def push(self, i: int, marker_pos: np.ndarray, marker_ori: np.ndarray) -> None:
        """Buffer frames for stream ``i`` ((K, M*3), (K, M*9)); no device work."""
        bp, bo = self._bufs[i]
        bp.extend(np.asarray(marker_pos, np.float32).reshape(-1, self.m * 3))
        bo.extend(np.asarray(marker_ori, np.float32).reshape(-1, self.m * 9))

    def pending(self, i: int) -> int:
        return len(self._bufs[i][0])

    def step(self, flush_ids=()) -> Dict[int, Dict[str, np.ndarray]]:
        """ONE batched forward serving every ready stream (one per shard
        with a ready stream, all issued before the first download).

        :return: {stream_id: {"root_ori", "pose_body"[, "shape"]}} for every
          stream that contributed frames.

        Spans (``utils/profiling.span``): ``serve.step``, counting
        ``rows_run`` (rows the forwards ran) and ``rows_ready`` (streams that
        contributed frames), around ``serve.pack``, each shard's
        ``serve.upload`` and ``serve.forward``, ``serve.download`` (which
        waits for the device) and ``serve.unpack``.
        """
        with span("serve.step") as sp:
            with span("serve.pack"):
                flush_ids = set(flush_ids)
                lengths = np.zeros(self.S, np.int64)
                packed_in = np.zeros((self.S, self.chunk, self.m * 12), np.float32)
                for i in range(self.S):
                    bp, bo = self._bufs[i]
                    k = self.chunk if len(bp) >= self.chunk else (len(bp) if i in flush_ids else 0)
                    if k == 0:
                        continue
                    lengths[i] = k
                    pos = np.stack(bp[:k] + [bp[k - 1]] * (self.chunk - k))
                    ori = np.stack(bo[:k] + [bo[k - 1]] * (self.chunk - k))
                    del bp[:k]
                    del bo[:k]
                    packed_in[i] = np.concatenate([pos, ori], axis=-1)
            if not lengths.any():
                return {}
            if self._offsets_dirty:
                with span("serve.upload"):
                    self._offsets_dev = [
                        (torch.from_numpy(self._offset_t[rows].copy()).to(d),
                         torch.from_numpy(self._offset_r[rows].copy()).to(d))
                        for rows, d in self._shard_rows()]
                self._offsets_dirty = False
            issued = []
            for s, (rows, _) in enumerate(self._shard_rows()):
                if not lengths[rows].any():
                    continue  # every stream of the shard idle: its state stays as it is
                packed, widths, self._carries[s] = _forward(
                    self.replicas[s], self.m * 3, packed_in[rows], lengths[rows],
                    *self._offsets_dev[s], self._carries[s])
                issued.append((rows, packed))
            with span("serve.download"):
                packed = np.zeros((self.S, self.chunk, issued[0][1].shape[-1]), np.float32)
                for rows, dev_packed in issued:
                    packed[rows] = dev_packed.cpu().numpy()
            with span("serve.unpack"):
                outs: Dict[int, Dict[str, np.ndarray]] = {}
                for i in np.nonzero(lengths)[0]:
                    out = _unpack_rows(widths, packed[i, : lengths[i]])
                    if "shape" in out:
                        if self._first_shape[i] is None:
                            self._first_shape[i] = out["shape"][0]
                        out["shape"] = np.broadcast_to(self._first_shape[i], out["shape"].shape)
                    outs[int(i)] = out
            if sp.recording:
                sp.count(rows_run=self.per_shard * len(issued), rows_ready=len(outs))
        return outs

    def _shard_rows(self):
        """(row slice, device) of each shard."""
        return [(slice(s * self.per_shard, (s + 1) * self.per_shard),
                 _model_device(r)) for s, r in enumerate(self.replicas)]

    def flush(self, ids) -> Dict[int, Dict[str, np.ndarray]]:
        """Fully drain the listed streams' buffers (any number of frames),
        looping ``step`` and concatenating each stream's outputs in order."""
        ids = list(ids)
        outs: Dict[int, list] = {}
        while any(self.pending(i) for i in ids):
            for i, out in self.step(flush_ids=[i for i in ids if self.pending(i)]).items():
                outs.setdefault(i, []).append(out)
        return {i: {k: np.concatenate([o[k] for o in parts]) for k in parts[0]}
                for i, parts in outs.items()}


def _record(out: Dict[str, np.ndarray], i: int, frame: int, stream=None) -> str:
    rec = {} if stream is None else {"stream": stream}
    rec.update({"frame": frame, "root_ori": out["root_ori"][i].tolist(),
                "pose_body": out["pose_body"][i].tolist()})
    if "shape" in out:
        rec["shape"] = out["shape"][i].tolist()
    return json.dumps(rec)


def main(args) -> None:
    set_precision(args.precision)
    if args.streams > 1:
        return main_multi(args)
    if getattr(args, "dp_devices", 1) > 1:
        raise SystemExit("--dp_devices shards the STREAM axis and requires --streams > 1 "
                         "(single-session serving is one row; there is nothing to shard).")
    predictor = StreamingPredictor.from_experiment(args.model_id, chunk_size=args.chunk,
                                                   device=args.device)
    frame_idx = 0

    def emit(out):
        nonlocal frame_idx
        if out is None:
            return
        for i in range(out["pose_body"].shape[0]):
            print(_record(out, i, frame_idx), flush=True)
            frame_idx += 1

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        if msg.get("cmd") == "reset":
            emit(predictor.flush())
            predictor.reset()
            frame_idx = 0
            continue
        if msg.get("cmd") == "flush":
            emit(predictor.flush())
            continue
        emit(predictor.push(np.asarray(msg["marker_pos"], np.float32)[None],
                            np.asarray(msg["marker_ori"], np.float32)[None]))
    emit(predictor.flush())


def main_multi(args) -> None:
    """Multi-session server: input records carry a "stream" id (0-based);
    output records echo it with a per-stream frame index."""
    n_dp = getattr(args, "dp_devices", 1)
    mesh = make_mesh(n_dp, args.device) if n_dp > 1 else None
    predictor = MultiStreamPredictor.from_experiment(
        args.model_id, n_streams=args.streams, chunk_size=args.chunk, device=args.device,
        mesh=mesh)
    frame_idx = [0] * args.streams

    def emit(outs):
        for sid, out in sorted(outs.items()):
            for i in range(out["pose_body"].shape[0]):
                print(_record(out, i, frame_idx[sid], stream=sid), flush=True)
                frame_idx[sid] += 1

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        sid = int(msg.get("stream", 0))
        if not 0 <= sid < args.streams:
            print(f"serve: dropping record with stream id {sid} "
                  f"(server runs --streams {args.streams})", file=sys.stderr)
            continue
        if msg.get("cmd") == "reset":
            emit(predictor.flush([sid]))
            predictor.reset(sid)
            frame_idx[sid] = 0
            continue
        if msg.get("cmd") == "flush":
            emit(predictor.flush([sid]))
            continue
        predictor.push(sid, np.asarray(msg["marker_pos"], np.float32)[None],
                       np.asarray(msg["marker_ori"], np.float32)[None])
        if predictor.pending(sid) >= args.chunk:
            emit(predictor.step())
    emit(predictor.flush(range(args.streams)))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.serve")
    p.add_argument("--model_id", required=True)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--streams", type=int, default=1,
                   help="Serve N independent sessions batched into one forward.")
    p.add_argument("--dp_devices", type=int, default=1,
                   help="Split the stream axis over this many devices, a replica of the "
                        "model on each (the CUDA cards 0..N-1; with --device cpu, the CPU "
                        "N times); --streams must be divisible by it.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--precision", choices=tuple(PRECISIONS), default="highest",
                   help="Matmul precision of the NN and kinematics GEMMs: 'highest' = fp32 "
                        "(TF32 off), the parity mode; 'high' = 3-pass bf16; 'default' = the "
                        "bf16-input serving mode (LSTM kernels on the tensor cores).")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
