"""Streaming-serving latency benchmark: per-chunk p50/p95/p99 (port of
``tools/bench_serve.py``).

Measures the deploy-path latency of ``StreamingPredictor`` (the push API of
``python -m empose_tpu_torch.serve``) for the flagship LGD-RNN-6 (seeded
random weights on the synthetic SMPL-H) at a given chunk size: frames
arrive one at a time; every ``chunk`` frames one forward fires, and the wall
clock from the firing frame's push to its poses is recorded. Also reports
the real-time margin against the 60 fps sensor rate.

    python -m empose_tpu_torch.tools.bench_serve [--chunk 16] [--n 200] [--device cpu]

With ``--streams S`` it benchmarks ``MultiStreamPredictor`` instead: all S
sessions receive a chunk, ONE batched forward serves them, and the report
adds the aggregate frame rate and the number of 60 fps sessions the card
sustains at that latency.

    python -m empose_tpu_torch.tools.bench_serve --streams 64 [--chunk 16] [--n 100]

Runs on CUDA unless ``--device cpu``; ``main`` returns its numbers as a dict.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.bodymodel.synthetic import make_synthetic_smplh
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import resolve_device, set_precision
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.serve import MultiStreamPredictor, StreamingPredictor

# The released LGD-RNN-6 architecture at full width (5,721,250 parameters),
# as the JAX tool's flagship config; ``tiny`` is its test size.
FLAGSHIP = dict(
    m_type="lgd", m_rnn_init=True, m_use_gradient=True, m_average_shape=True,
    m_estimate_shape=False, m_num_iterations=2, m_hidden_size=512, m_num_layers=2,
    m_rnn_hidden_size=512, m_rnn_num_layers=2, m_rnn_bidirectional=False, m_step_size=0.1,
    m_reprojection_loss_weight=0.01, m_pose_loss_weight=10.0, m_fk_loss=0.1,
    use_marker_pos=True, use_marker_ori=True, use_real_offsets=True, offset_noise_level=0,
    n_markers=6, window_size=64, bs_train=2, lr=5e-4, seed=0)
TINY = dict(m_hidden_size=64, m_num_layers=1, m_rnn_hidden_size=32, m_rnn_num_layers=1,
            window_size=8)
WARMUP = 5


def flagship_model(device, tiny: bool = False, seed: int = 0):
    """LGD-RNN-6 (``tiny``: its test widths) with weights drawn from ``seed``
    on the synthetic SMPL-H, in eval mode on ``device``."""
    config = Configuration.from_dict(dict(FLAGSHIP, **(TINY if tiny else {})))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        np.savez(path, **make_synthetic_smplh(seed=0))
        smplh = load_smplh(path)
    model = create_model(config, SensorSMPL(smplh))
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.bench_serve")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--n", type=int, default=200, help="number of timed chunks")
    p.add_argument("--streams", type=int, default=1,
                   help="benchmark MultiStreamPredictor with S batched sessions")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true", help="the model at its test widths")
    return p


def _percentiles(lat) -> Dict[str, float]:
    lat = np.sort(np.asarray(lat))
    return {"p50": float(np.percentile(lat, 50)), "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)), "max": float(lat[-1])}


def main(argv: Optional[list] = None) -> Dict[str, float]:
    args = parser().parse_args(argv)
    set_precision("highest")
    model = flagship_model(resolve_device(args.device), tiny=args.tiny)
    if args.streams > 1:
        return bench_multi(model, args)
    pred = StreamingPredictor(model, chunk_size=args.chunk)

    rng = np.random.RandomState(0)
    frame_pos = (rng.randn(args.n + WARMUP, args.chunk, 36) * 0.3).astype(np.float32)
    frame_ori = rng.randn(args.n + WARMUP, args.chunk, 108).astype(np.float32)

    for i in range(WARMUP):  # first launches
        for f in range(args.chunk):
            pred.push(frame_pos[i, f][None], frame_ori[i, f][None])

    lat = []
    for i in range(WARMUP, args.n + WARMUP):
        # Push chunk-1 frames (buffered, no compute), time the firing frame.
        for f in range(args.chunk - 1):
            out = pred.push(frame_pos[i, f][None], frame_ori[i, f][None])
            assert not out, "chunk fired early"
        t0 = time.perf_counter()
        out = pred.push(frame_pos[i, -1][None], frame_ori[i, -1][None])
        lat.append((time.perf_counter() - t0) * 1e3)
        assert out and out["pose_body"].shape[0] == args.chunk

    r = _percentiles(lat)
    p50, p95, p99 = r["p50"], r["p95"], r["p99"]
    budget_ms = args.chunk / 60.0 * 1e3  # 60 fps sensor rate
    print(f"chunk={args.chunk} frames  timed_chunks={args.n}")
    print(f"per-chunk latency: p50 {p50:.2f} ms  p95 {p95:.2f} ms  p99 {p99:.2f} ms  "
          f"max {r['max']:.2f} ms")
    print(f"added latency per frame (p50): {p50 / args.chunk:.3f} ms")
    print(f"real-time budget at 60 fps: {budget_ms:.1f} ms/chunk -> "
          f"{budget_ms / p50:.1f}x headroom (p50), {budget_ms / p99:.1f}x (p99)")
    return dict(r, streams=1, chunk=args.chunk, n=args.n,
                frames_per_s=args.chunk / (p50 / 1e3), forwards=args.n + WARMUP)


def bench_multi(model, args) -> Dict[str, float]:
    S, chunk = args.streams, args.chunk
    pred = MultiStreamPredictor(model, n_streams=S, chunk_size=chunk)
    rng = np.random.RandomState(0)
    pos = (rng.randn(S, chunk, 36) * 0.3).astype(np.float32)
    ori = rng.randn(S, chunk, 108).astype(np.float32)

    def feed_all():
        for i in range(S):
            pred.push(i, pos[i], ori[i])

    for _ in range(WARMUP):  # first launches
        feed_all()
        pred.step()

    lat = []
    for _ in range(args.n):
        feed_all()
        t0 = time.perf_counter()
        outs = pred.step()
        lat.append((time.perf_counter() - t0) * 1e3)
        assert len(outs) == S
    r = _percentiles(lat)
    p50, p99 = r["p50"], r["p99"]
    budget_ms = chunk / 60.0 * 1e3
    agg = S * chunk / (p50 / 1e3)
    print(f"streams={S} chunk={chunk}  timed_steps={args.n}")
    print(f"per-step latency (all {S} sessions): p50 {p50:.2f} ms  p99 {p99:.2f} ms")
    print(f"aggregate rate at p50: {agg:,.0f} frames/s")
    print(f"real-time budget at 60 fps: {budget_ms:.1f} ms/chunk -> "
          f"{budget_ms / p50:.1f}x headroom (p50); "
          f"~{int(S * budget_ms / p50):,} sustainable 60 fps sessions/chip at this latency")
    return dict(r, streams=S, chunk=chunk, n=args.n, frames_per_s=agg,
                forwards=args.n + WARMUP)


if __name__ == "__main__":
    main()
