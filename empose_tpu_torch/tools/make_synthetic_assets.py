"""Write a full synthetic asset tree for development, tests and the gates
(port of ``tools/make_synthetic_assets.py``).

Creates structurally faithful stand-ins for the licensed assets:

  <out>/smpl_models/smplh_amass/neutral/model.npz   synthetic SMPL-H
  <out>/data_real/<subj>_seq<i>_clean.npz           real-recording format
  <out>/data_real/<subj>_offsets.npz                per-subject offsets
  <out>/data_real/hold_out/0715_seq0_clean.npz      cross-subject split
  <out>/data_synth/amass_emr/corpus.emr             training corpus
  <out>/data_synth/3dpw_emr/corpus.emr              validation corpus
  <out>/experiments/

The recordings are self-consistent: their sensor readings come from the
port's own FK, virtual sensors and mounting offsets over smooth random
poses, so models can fit them. Every numpy draw is the JAX tool's, in its
order, so everything the draws alone decide (poses, shapes, translations,
masks, offsets, corpus meta) equals the JAX tool's tree bit for bit; the
FK and sensor fields agree to float32 rounding. The FK runs on the device
in chunks of ``FK_CHUNK`` frames (the JAX tool pads to 256 frames only to
spare XLA recompiles).

    python -m empose_tpu_torch.tools.make_synthetic_assets [--out assets] [--seed 0] \\
        [--n_real 4] [--n_amass 8] [--n_frames 120] [--device cpu]

Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import zlib
from typing import Optional

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel import synthetic as S
from empose_tpu_torch.bodymodel.smplh import load_smplh, smplh_fk
from empose_tpu_torch.data.emr import EMRWriter
from empose_tpu_torch.data.virtual_sensors import subset_tables, virtual_pos_and_rot
from empose_tpu_torch.device import disable_tf32, resolve_device

FK_CHUNK = 1024


def _fk(model, poses: np.ndarray, shape: np.ndarray, trans: np.ndarray, want_vertices: bool):
    """FK of one sequence on the model's device, ``FK_CHUNK`` frames a call:
    (vertices or None, joints) as device tensors."""
    dev = model.v_template.device
    betas = torch.from_numpy(shape[None]).to(dev)
    verts, joints = [], []
    with torch.no_grad():
        for s in range(0, poses.shape[0], FK_CHUNK):
            p = torch.from_numpy(poses[s:s + FK_CHUNK]).to(dev)
            t = torch.from_numpy(trans[s:s + FK_CHUNK]).to(dev)
            v, j = smplh_fk(model, p[:, 3:], betas, p[:, :3], t, want_vertices=want_vertices)
            verts.append(v)
            joints.append(j)
    return (torch.cat(verts) if want_vertices else None), torch.cat(joints)


def _recording_draws(seed: int, subj: str, seq_idx: int, n_frames: int):
    """A recording's random stream and its first draws: (stream, poses,
    shape, trans); the stream then draws the position noise and the gaps."""
    r = np.random.RandomState(seed * 1000 + int(subj) + seq_idx)
    poses = S.smooth_random_poses(r, n_frames, 66, scale=0.35).astype(np.float32)
    shape = (r.randn(10) * 0.5).astype(np.float32)
    trans = S.smooth_random_poses(r, n_frames, 3, scale=0.3).astype(np.float32)
    return r, poses, shape, trans


def sensors_in_float64(out_dir: str, rel: str, seed: int):
    """The reference of a tree's sensor fields: ``sensor_pos`` and
    ``sensor_oris`` of recording ``rel`` (a path under ``out_dir``, named
    ``<subj>_seq<i>_clean.npz``) recomputed on the CPU in float64 from the
    same draws, as (frames, 12, 3) and (frames, 12, 9). The float32 fields
    lie up to ~4e-4 from it: a frame is built from vertices a centimetre
    apart on a metre-scale mesh, and some triangles of the synthetic mesh
    are thin."""
    subj, seq = os.path.basename(rel).split("_")[:2]
    rec = np.load(os.path.join(out_dir, rel))
    n = rec["smpl_poses"].shape[0]
    r, poses, shape, trans = _recording_draws(seed, subj, int(seq[3:]), n)
    model = load_smplh(os.path.join(out_dir, "smpl_models", "smplh_amass", "neutral",
                                    "model.npz"), dtype=np.float64)
    req, tables = subset_tables(model.faces, C.VERTEX_IDS)
    p = torch.from_numpy(poses).double()
    verts, _ = smplh_fk(model.subset(req).to("cpu", dtype=torch.float64), p[:, 3:],
                        torch.from_numpy(shape).double()[None], p[:, :3],
                        torch.from_numpy(trans).double())
    pos, ori, _ = virtual_pos_and_rot(verts, tables.to("cpu"))
    pos, ori = pos.numpy(), ori.numpy()
    ori_corr = np.einsum("fmab,mbc->fmac", ori, rec["offset_r"])
    pos_corr = pos + np.einsum("fmab,mb->fma", ori, rec["offset_means"])
    pos_corr = pos_corr + r.randn(*pos_corr.shape) * 0.002
    return pos_corr, ori_corr.reshape(n, 12, 9)


def generate_all(out_dir: str, n_real_sequences: int = 4, n_amass_sequences: int = 8,
                 n_frames: int = 120, seed: int = 0, n_subjects: int = 2,
                 device=None) -> None:
    """Write the tree under ``out_dir`` (the SMPL-H model is kept where it
    exists). ``device``: None = CUDA (raises without it); ``"cpu"``."""
    dev = resolve_device(device)
    disable_tf32()

    # 1. SMPL-H model.
    smpl_dir = os.path.join(out_dir, "smpl_models", "smplh_amass", "neutral")
    os.makedirs(smpl_dir, exist_ok=True)
    model_path = os.path.join(smpl_dir, "model.npz")
    if not os.path.exists(model_path):
        np.savez(model_path, **S.make_synthetic_smplh(seed=seed))
    model = load_smplh(model_path)
    req, tables = subset_tables(model.faces, C.VERTEX_IDS)
    sub = model.subset(req).to(dev)
    tables = tables.to(dev)
    model = model.to(dev)

    # 2. Per-subject offsets.
    real_dir = os.path.join(out_dir, "data_real")
    hold_out_dir = os.path.join(real_dir, "hold_out")
    os.makedirs(hold_out_dir, exist_ok=True)
    subjects = [f"{i:04d}" for i in range(402, 402 + n_subjects)] + ["0715"]
    offsets = {}
    for subj in subjects:
        off = S.make_offset_data(np.random.RandomState(seed + int(subj)))
        offsets[subj] = off
        np.savez(os.path.join(real_dir, f"{subj}_offsets.npz"), **off)

    # 3. Real recordings: sensor readings synthesized by the pipeline itself.
    def synth_recording(subj: str, seq_idx: int, out_path: str) -> None:
        r, poses, shape, trans = _recording_draws(seed, subj, seq_idx, n_frames)
        verts, _ = _fk(sub, poses, shape, trans, want_vertices=True)
        with torch.no_grad():
            pos, ori, _ = virtual_pos_and_rot(verts, tables)
        pos, ori = pos.cpu().numpy(), ori.cpu().numpy()
        off = offsets[subj]
        ori_corr = np.einsum("fmab,mbc->fmac", ori, off["r"])
        pos_corr = pos + np.einsum("fmab,mb->fma", ori, off["means"])
        # Sensor noise + occasional missing markers.
        pos_corr = pos_corr + r.randn(*pos_corr.shape) * 0.002
        masks = np.ones((n_frames, 12), np.float32)
        for _ in range(2):
            m0 = r.randint(0, 12)
            t0 = r.randint(0, n_frames - 5)
            masks[t0:t0 + 5, m0] = 0.0

        np.savez(out_path,
                 id=f"{subj}_seq{seq_idx}",
                 sensor_pos=pos_corr.reshape(n_frames, -1).astype(np.float32),
                 sensor_oris=ori_corr.reshape(n_frames, -1).astype(np.float32),
                 sensor_masks=masks,
                 smpl_poses=poses, smpl_shape=shape, smpl_trans=trans,
                 offset_means=off["means"], offset_covs=off["covs"], offset_r=off["r"])

    for i in range(n_real_sequences):
        subj = subjects[i % n_subjects]
        synth_recording(subj, i, os.path.join(real_dir, f"{subj}_seq{i}_clean.npz"))
    synth_recording("0715", 0, os.path.join(hold_out_dir, "0715_seq0_clean.npz"))

    # 4. Training corpora (AMASS-like + 3DPW-like) with precomputed joints.
    for name, count in (("amass_emr", n_amass_sequences),
                        ("3dpw_emr", max(2, n_amass_sequences // 2))):
        corp_dir = os.path.join(out_dir, "data_synth", name)
        os.makedirs(corp_dir, exist_ok=True)
        with EMRWriter(os.path.join(corp_dir, "corpus.emr")) as w:
            for i in range(count):
                r = np.random.RandomState(seed + zlib.crc32(name.encode()) % 1000 + i)
                nf = n_frames + r.randint(-n_frames // 4, n_frames // 4)
                poses = S.smooth_random_poses(r, nf, 66, scale=0.35).astype(np.float32)
                shape = (r.randn(10) * 0.5).astype(np.float32)
                trans = S.smooth_random_poses(r, nf, 3, scale=0.3).astype(np.float32)
                _, joints = _fk(model, poses, shape, trans, want_vertices=False)
                joints = joints[:, : C.N_JOINTS + 1].reshape(nf, -1).cpu().numpy()
                w.add_record({"id": f"{name}_{i}", "gender": "neutral", "n_frames": int(nf)},
                             {"poses": poses, "betas": shape, "trans": trans, "joints": joints})

    os.makedirs(os.path.join(out_dir, "experiments"), exist_ok=True)
    print(f"Synthetic assets written to {out_dir}")


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.make_synthetic_assets")
    p.add_argument("--out", default=C.DEFAULT_ASSETS_DIR)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_real", type=int, default=4)
    p.add_argument("--n_amass", type=int, default=8)
    p.add_argument("--n_frames", type=int, default=120)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default) or cpu.")
    args = p.parse_args(argv)
    generate_all(args.out, args.n_real, args.n_amass, args.n_frames, args.seed,
                 device=args.device)


if __name__ == "__main__":
    main()
