#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernel from empose_tpu_torch/csrc with nvcc;
  3. the LSTM stack kernel against its plain torch version on the card at
     the released init-RNN shape (L=2, H=512) for the batched serving chunk
     (F=16, N=64), the eval window (F=256, N=64) and one stream's chunk
     (F=16, N=1), with 0-length, partial and full rows and non-zero state;
  4. median times of the kernel, the plain version and torch.nn.LSTM
     (cuDNN, full lengths, same weights) at those shapes;
  5. the main path: full-width LGD-RNN-6 with seeded random weights written
     as a model.pth, served to 64 streams x 4 chunks of 16 frames through
     MultiStreamPredictor.from_experiment (with one reset, one flush and one
     idle stream) plus one StreamingPredictor session; the kernel launch
     count must grow by one per served forward and the served poses must
     equal the same model run with the plain LSTM version, within 1e-4;
  6. a "kernels" JSON line; 7. a last JSON line with the device.

Exits non-zero on any failure, and when no CUDA device is present.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.bodymodel.synthetic import make_offset_data, make_synthetic_smplh
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import set_precision
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.serve import MultiStreamPredictor, StreamingPredictor
from empose_tpu_torch.utils.experiments import count_parameters

SEED = 0
TOL = 1e-4
STREAMS, CHUNK, CHUNKS = 64, 16, 4
HIDDEN, LAYERS, N_IN = 512, 2, 6 * 12  # init RNN of LGD-RNN-6: 6 markers x (3 pos + 9 ori)
FP32_PEAK = 67e12    # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s

# The released LGD-RNN-6 architecture (bench.py:115-126).
LGD_RNN_6 = dict(
    m_type="ief", m_rnn_init=True, m_use_gradient=True, m_average_shape=True,
    m_estimate_shape=False, m_num_iterations=2, m_hidden_size=512, m_num_layers=2,
    m_rnn_hidden_size=512, m_rnn_num_layers=2, m_rnn_bidirectional=False,
    m_step_size=0.1, m_reprojection_loss_weight=0.01, m_fk_loss=0.1,
    m_pose_loss_weight=10.0, use_marker_pos=True, use_marker_ori=True,
    use_real_offsets=True, offset_noise_level=0, n_markers=6, window_size=256, lr=5e-4)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def stack_case(f: int, n: int, seed: int):
    """Random init-RNN weights and a batch with 0-length, partial and full rows."""
    g = torch.Generator().manual_seed(seed)
    bound = HIDDEN ** -0.5
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * bound).cuda()
    cells = [dict(w_ih=u(N_IN if l == 0 else HIDDEN, 4 * HIDDEN), w_hh=u(HIDDEN, 4 * HIDDEN),
                  b_ih=u(4 * HIDDEN), b_hh=u(4 * HIDDEN)) for l in range(LAYERS)]
    x = torch.randn(f, n, N_IN, generator=g).cuda()
    lengths = torch.randint(1, f, (n,), generator=g)
    lengths[: n // 16] = 0
    lengths[n // 16: n // 16 + n // 3] = f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().cuda()
    h0 = (torch.randn(LAYERS, n, HIDDEN, generator=g) * 0.5).cuda()
    c0 = (torch.randn(LAYERS, n, HIDDEN, generator=g) * 0.5).cuda()
    return cells, x, mask, h0, c0


def bound_ms(f: int, n: int) -> tuple:
    """Least time for the stack on this card: the larger of its fp32 FMA
    work over the fp32 peak and its bytes (each input read once, each
    output written once) over the memory rate."""
    h4 = 4 * HIDDEN
    flops = 2.0 * f * n * HIDDEN * h4 * (2 * LAYERS - 1)
    n_bytes = 4.0 * (f * n * h4 + f * n                       # x0_proj, mask
                     + (2 * LAYERS - 1) * HIDDEN * h4 + (LAYERS - 1) * h4  # weights, b_up
                     + 2 * LAYERS * n * HIDDEN                  # h0, c0
                     + f * n * HIDDEN + 2 * LAYERS * n * HIDDEN)  # outs, hF, cF
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, n_bytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(f: int, n: int, seed: int) -> dict:
    cells, x, mask, h0, c0 = stack_case(f, n, seed)
    args = K.stack_operands(cells, x)
    args = (args[0], mask, args[1], args[2], args[3], h0, c0)
    got = K.lstm_stack_fused(*args)
    want = K.lstm_stack_plain(*args)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    idle = mask.sum(0) == 0
    frozen = bool((got[1][:, idle] == h0[:, idle]).all() and (got[2][:, idle] == c0[:, idle]).all())
    print(f"kernel F={f} N={n}: max_abs_err vs plain {err:.3e} (outs, hF, cF); "
          f"0-length rows frozen bit for bit: {frozen}", flush=True)
    check(err <= TOL, f"kernel disagrees with its plain version at F={f}: {err} > {TOL}")
    check(frozen, f"kernel changed the state of 0-length rows at F={f}")

    lstm = torch.nn.LSTM(N_IN, HIDDEN, LAYERS).cuda()
    with torch.no_grad():
        for l, c in enumerate(cells):
            getattr(lstm, f"weight_ih_l{l}").copy_(c["w_ih"].t())
            getattr(lstm, f"weight_hh_l{l}").copy_(c["w_hh"].t())
            getattr(lstm, f"bias_ih_l{l}").copy_(c["b_ih"])
            getattr(lstm, f"bias_hh_l{l}").copy_(c["b_hh"])
        full = torch.ones_like(mask)
        lib_err = (lstm(x, (h0, c0))[0] - K.lstm_stack(cells, x, full, h0, c0, K.lstm_stack_plain)[0]
                   ).abs().max().item()
        ms = cuda_ms(lambda: K.lstm_stack_fused(*args))
        stack_ms = cuda_ms(lambda: K.lstm_stack(cells, x, mask, h0, c0))
        plain_ms = cuda_ms(lambda: K.lstm_stack_plain(*args), reps=7 if f > 64 else 15)
        library_ms = cuda_ms(lambda: lstm(x, (h0, c0)))
    b_ms, b_by = bound_ms(f, n)
    print(f"times F={f} N={n}: kernel {ms:.4f} ms, kernel with input projection "
          f"{stack_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.nn.LSTM (cuDNN, from x) "
          f"{library_ms:.4f} ms (max diff to plain at full lengths {lib_err:.2e}), "
          f"bound {b_ms:.4f} ms by {b_by}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def write_experiment(root: str, model_id: str) -> int:
    """Synthetic SMPL-H npz and an experiment dir with a seeded full-width
    LGD-RNN-6 model.pth; returns the parameter count."""
    smpl_dir = os.path.join(root, "smpl_models", "smplh_amass", "neutral")
    os.makedirs(smpl_dir)
    np.savez(os.path.join(smpl_dir, "model.npz"), **make_synthetic_smplh(seed=SEED))
    os.environ["SMPL_MODELS"] = os.path.join(root, "smpl_models")
    os.environ["EM_EXPERIMENTS"] = os.path.join(root, "experiments")
    config = Configuration.from_dict(LGD_RNN_6)
    model = create_model(config, SensorSMPL(load_smplh()))
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model_dir = os.path.join(root, "experiments", f"{model_id}-LGD-RNN-6")
    os.makedirs(model_dir)
    config.to_json(os.path.join(model_dir, "config.json"))
    torch.save({"model_state_dict": model.state_dict(), "iteration": 0, "epoch": 0},
               os.path.join(model_dir, "model.pth"))
    return count_parameters(model)


def sensor_feeds(sensor: SensorSMPL, n_streams: int, n_frames: int, rng):
    """Realistic sensor readings: the port's own FK and virtual sensors over
    smooth random poses, one sequence per stream. (n_streams, n_frames, 36/108)."""
    t = np.linspace(0.0, 1.0, n_frames)
    ctrl_t = np.linspace(0.0, 1.0, 6)
    ctrl = rng.randn(n_streams, 6, 66) * 0.3
    poses = np.stack([np.stack([np.interp(t, ctrl_t, ctrl[s, :, d]) for d in range(66)], -1)
                      for s in range(n_streams)]).astype(np.float32)
    with torch.no_grad():
        p = torch.from_numpy(poses.reshape(-1, 66)).cuda()
        pos, ori, _, _ = sensor.markers_and_joints(p, p.new_zeros(p.shape[0], 10))
    pos = pos.reshape(n_streams, n_frames, -1).cpu().numpy()
    ori = ori.reshape(n_streams, n_frames, -1).cpu().numpy()
    return pos, ori


def max_diff(a: dict, b: dict) -> float:
    if set(a) != set(b):
        return float("inf")
    return max(float(np.abs(a[s][k] - b[s][k]).max()) for s in a for k in a[s])


def serve_rounds(multi, feeds, offsets):
    """64 streams x 4 chunks, one batched step per chunk: stream 1 resets
    before chunk 2, stream 2 is idle in chunk 2, stream 3 sends 9 frames in
    chunk 3 and is flushed. Returns the per-step outputs."""
    pos, ori = feeds
    for s in range(STREAMS):
        multi.set_offsets(s, *offsets[s])
    outs = []
    for c in range(CHUNKS):
        if c == 2:
            multi.reset(1)
        for s in range(STREAMS):
            if c == 2 and s == 2:
                continue
            k = 9 if (c == 3 and s == 3) else CHUNK
            sl = slice(c * CHUNK, c * CHUNK + k)
            multi.push(s, pos[s, sl], ori[s, sl])
        outs.append(multi.step(flush_ids=[3] if c == 3 else ()))
    return outs


def single_session(single, feeds, offsets):
    pos, ori = feeds
    single.offset_t, single.offset_r = offsets[0]
    out = single.push(pos[0, : CHUNK * CHUNKS - 5], ori[0, : CHUNK * CHUNKS - 5])
    return {0: out}, {0: single.flush()}


def serving_times(multi, single, feeds) -> None:
    """p50 of the batched step (host packing, forward, the one download) and
    of a single-stream chunk; then one profiled window of 5 batched steps:
    device busy time (sum of kernel times), kernels launched per step and the
    largest device-time entries."""
    from torch.profiler import ProfilerActivity, profile

    pos, ori = feeds

    def batched_step() -> float:
        for s in range(STREAMS):
            multi.push(s, pos[s, :CHUNK], ori[s, :CHUNK])
        t0 = time.perf_counter()
        multi.step()
        return (time.perf_counter() - t0) * 1e3

    step_ms = [batched_step() for _ in range(20)]
    single_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        single.push(pos[0, :CHUNK], ori[0, :CHUNK])
        single_ms.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(step_ms))
    print(f"serving: {STREAMS} streams x chunk {CHUNK}: p50 {p50:.3f} ms per batched step "
          f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{STREAMS * CHUNK / p50 * 1e3:.1f} frames/s; single stream p50 "
          f"{float(np.median(single_ms)):.3f} ms per chunk", flush=True)

    n_steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batched_step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            / 1e3 / n_steps for e in dev}
    launches = sum(e.count for e in dev) / n_steps
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    print(f"serving profile (5 steps, profiler on): wall {wall_ms:.3f} ms per step, device busy "
          f"{total:.3f} ms ({100 * total / wall_ms:.1f}%), {launches:.0f} device ops per step; "
          "largest: " + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    set_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    log = K.build(force=True, verbose=True)
    regs = sorted({line.split("info    : ")[-1] for line in log.splitlines() if "registers" in line})
    print(f"build: nvcc {time.perf_counter() - t0:.2f} s; {'; '.join(regs)}", flush=True)

    # The batched serving chunk, the eval window, and one stream's chunk.
    stack = {(f, n): kernel_phase(f, n, seed=SEED + f + n)
             for f, n in ((CHUNK, STREAMS), (256, STREAMS), (CHUNK, 1))}

    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as root:
        n_params = write_experiment(root, "900001")
        print(f"model: LGD-RNN-6, {n_params} parameters (seeded random weights)", flush=True)
        multi = MultiStreamPredictor.from_experiment("900001", n_streams=STREAMS, chunk_size=CHUNK)
        model = multi.model
        check(next(model.parameters()).is_cuda, "the model is not on the card")
        rng = np.random.RandomState(SEED)
        feeds = sensor_feeds(model.smpl, STREAMS, CHUNK * CHUNKS, rng)
        offsets = [(o["means"], o["r"]) for o in (make_offset_data(rng) for _ in range(STREAMS))]
        single = StreamingPredictor(model, CHUNK)

        torch.cuda.synchronize()
        K.LAUNCHES = 0
        served = serve_rounds(multi, feeds, offsets)
        single_out = single_session(single, feeds, offsets)
        torch.cuda.synchronize()
        launches = K.LAUNCHES
        forwards = len(served) + 4  # single session: 3 full chunks + 1 flush
        print(f"main path: {forwards} served forwards, {launches} kernel launches", flush=True)
        check(launches == forwards, f"expected one launch per served forward, "
                                    f"got {launches} for {forwards}")

        ref_model = copy.deepcopy(model)
        ref_model.rnn.lstm_stack = K.lstm_stack_plain
        ref_served = serve_rounds(MultiStreamPredictor(ref_model, STREAMS, CHUNK), feeds, offsets)
        ref_single = single_session(StreamingPredictor(ref_model, CHUNK), feeds, offsets)
        check(K.LAUNCHES == launches, "the plain reference launched the kernel")
        finite = all(np.isfinite(v).all() for o in served for s in o.values() for v in s.values())
        shapes_ok = served[0][0]["pose_body"].shape == (CHUNK, 63) and \
            served[3][3]["pose_body"].shape == (9, 63) and 1 in served[2] and 2 not in served[2]
        err = max(max(max_diff(a, b) for a, b in zip(served, ref_served)),
                  max(max_diff(a, b) for a, b in zip(single_out, ref_single)))
        print(f"main path: outputs finite {finite}, shapes {shapes_ok}, max |kernel path - "
              f"plain LSTM path| {err:.3e} over {len(served)} steps x {STREAMS} streams "
              f"and the single session", flush=True)
        check(finite and shapes_ok, "served outputs are not finite or have wrong shapes")
        check(err <= TOL, f"served poses differ from the plain-LSTM forward: {err} > {TOL}")

        serving_times(multi, single, feeds)

    f16 = stack[(CHUNK, STREAMS)]
    kernels = [dict(name="lstm_stack", route="cuda", source="empose_tpu_torch/csrc/lstm_stack.cu",
                    replaces="empose_tpu/ops/lstm_kernel.py:150", launches=launches,
                    max_abs_err=f16["max_abs_err"], ms=f16["ms"], plain_ms=f16["plain_ms"],
                    bound_ms=f16["bound_ms"], bound_by=f16["bound_by"],
                    library_ms=f16["library_ms"])]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
