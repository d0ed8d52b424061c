"""Offline datagen: AMASS npz and 3DPW pkl trees -> 60 fps EMR corpora with joints.

Port of ``scripts/preprocess_amass_3dpw.py``: walks the AMASS tree (with the
same two-file denylist, skipping ``*shape.npz``), resamples rotations by
SQUAD and positions by cubic splines to 60 fps, runs SMPL-H FK on the card
for the ground-truth joints in chunks of at most 1024 frames
(``SMPLLayer.fk_joints``: joints only, no skinning), and writes EMR record
files with the port's ``EMRWriter``.

    python -m empose_tpu_torch.preprocess --amass      # $EM_DATA_SYNTH/amass -> amass_emr
    python -m empose_tpu_torch.preprocess --threedpw   # $EM_DATA_SYNTH/3dpw -> 3dpw_emr
        [--amass_in DIR] [--amass_out FILE] [--threedpw_in DIR]
        [--threedpw_out FILE] [--device cuda|cpu]

The body model is ``$SMPL_MODELS``' SMPL-H. FK runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import pickle as pkl
import time
from pathlib import Path

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import SMPLLayer, load_smplh
from empose_tpu_torch.data.emr import EMRWriter
from empose_tpu_torch.ops.quaternions import resample_rotations

AMASS_DENYLIST = ("MTR03_poses.npz", "WalkingStraightBackwards08_poses.npz")
FK_CHUNK = 1024  # frames per FK call


def get_all_valid_files(directory, is_valid_file, denylist):
    """Recursive deterministic file walk: sorted directories and names."""
    directory = os.path.expanduser(directory)
    data_paths = []
    for root, dirs, f_names in os.walk(directory):
        dirs.sort()
        for f in sorted(f_names):
            if is_valid_file(f) and f not in denylist:
                data_paths.append(Path(os.path.join(root, f)).resolve())
    return data_paths


def get_all_amass_file_ids(amass_dir):
    """AMASS sequence ids relative to ``amass_dir`` (no shapes, no denylist)."""
    all_paths = get_all_valid_files(
        amass_dir, lambda x: x.endswith(".npz") and not x.endswith("shape.npz"),
        denylist=AMASS_DENYLIST)
    amass_dir = Path(amass_dir).resolve()
    return [str(p.relative_to(amass_dir)) for p in all_paths]


def resample_positions(positions: np.ndarray, fps_in: float, fps_out: float) -> np.ndarray:
    """Cubic-spline resampling of (F, ...) positions from ``fps_in`` to ``fps_out``."""
    n_frames = positions.shape[0]
    if n_frames < 2:
        raise ValueError("resampling needs at least two frames")
    duration = n_frames / fps_in
    ts_in = np.arange(0, duration, 1 / fps_in)[:n_frames]
    ts_out = np.arange(0, duration, 1 / fps_out)
    return CubicSpline(ts_in, positions, axis=0)(ts_out)


class ChunkedFK:
    """Root and body joints of pose sequences, FK on ``device`` in chunks of
    at most ``FK_CHUNK`` frames; the body model goes to the device once.
    ``frames`` and ``seconds`` add up the FK work done (host clock, including
    the uploads and the download of each chunk)."""

    def __init__(self, device=None, npz_path=None):
        self.layer = SMPLLayer(load_smplh(npz_path), device)
        self.frames, self.seconds = 0, 0.0

    def joints(self, poses: np.ndarray, betas: np.ndarray, trans: np.ndarray) -> np.ndarray:
        """(F, 66) poses, (10,) betas, (F, 3) trans -> (F, 66) joints."""
        t0 = time.perf_counter()
        out = []
        for s in range(0, poses.shape[0], FK_CHUNK):
            chunk = np.asarray(poses[s:s + FK_CHUNK], np.float32)
            js = self.layer.fk_joints(chunk[:, 3:], np.asarray(betas[None], np.float32),
                                      chunk[:, :3],
                                      np.asarray(trans[s:s + FK_CHUNK], np.float32))
            out.append(js[:, : C.N_JOINTS + 1].reshape(chunk.shape[0], -1).cpu().numpy())
        self.frames += poses.shape[0]
        self.seconds += time.perf_counter() - t0
        return np.concatenate(out, axis=0)


def convert_amass_to_emr(output_file: str, amass_root: str, device=None,
                         fk: ChunkedFK = None) -> int:
    """AMASS npz tree -> EMR corpus at 60 fps; returns the record count."""
    print(f"Converting AMASS data under {amass_root} -> {output_file} ...")
    file_ids = get_all_amass_file_ids(amass_root)
    fk = fk or ChunkedFK(device)
    os.makedirs(os.path.dirname(output_file), exist_ok=True)

    with EMRWriter(output_file) as w:
        for i, file_id in enumerate(file_ids):
            sample = np.load(os.path.join(amass_root, file_id))
            poses = sample["poses"][:, : C.MAX_INDEX_ROOT_AND_BODY]
            betas = sample["betas"][: C.N_SHAPE_PARAMS]
            trans = sample["trans"]
            fps = float(sample["mocap_framerate"])
            gender = sample["gender"].tolist()
            if not isinstance(gender, str):
                gender = gender.decode()

            n_frames, n_coords = poses.shape
            poses = resample_rotations(poses.reshape(n_frames, -1, 3), fps, C.FPS).reshape(-1, n_coords)
            trans = resample_positions(trans, fps, C.FPS)
            n_frames = poses.shape[0]
            joints = fk.joints(poses, betas, trans)
            w.add_record({"id": file_id, "gender": gender, "n_frames": int(n_frames)},
                         {"poses": poses.astype(np.float32), "betas": betas.astype(np.float32),
                          "trans": trans.astype(np.float32), "joints": joints.astype(np.float32)})
            if (i + 1) % 100 == 0:
                print(f"  {i + 1}/{len(file_ids)}")
    print(f"Wrote {len(file_ids)} sequences.")
    return len(file_ids)


def convert_3dpw_to_emr(output_file: str, threedpw_root: str, device=None,
                        fk: ChunkedFK = None) -> int:
    """3DPW pkl tree -> EMR corpus, one record per subject, genders as
    female/male, poses already at 60 Hz; returns the record count."""
    print(f"Converting 3DPW data under {threedpw_root} -> {output_file} ...")
    fk = fk or ChunkedFK(device)
    pkl_files = []
    for root_dir, dirs, files in os.walk(threedpw_root):
        dirs.sort()
        pkl_files += [os.path.join(root_dir, f) for f in sorted(files) if f.endswith(".pkl")]

    os.makedirs(os.path.dirname(output_file), exist_ok=True)
    count = 0
    with EMRWriter(output_file) as w:
        for path in pkl_files:
            file_id = os.path.split(path)[-1]
            with open(path, "rb") as f:
                sample = pkl.load(f, encoding="latin1")
            for s in range(len(sample["poses_60Hz"])):
                poses = sample["poses_60Hz"][s][:, : C.MAX_INDEX_ROOT_AND_BODY]
                betas = sample["betas"][s][: C.N_SHAPE_PARAMS]
                trans = sample["trans_60Hz"][s]
                gender = "female" if sample["genders"][s] == "f" else "male"
                joints = fk.joints(poses, betas, trans)
                w.add_record({"id": file_id, "gender": gender, "n_frames": int(poses.shape[0])},
                             {"poses": poses.astype(np.float32), "betas": betas.astype(np.float32),
                              "trans": trans.astype(np.float32), "joints": joints.astype(np.float32)})
                count += 1
    print(f"Wrote {count} sequences.")
    return count


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.preprocess")
    p.add_argument("--amass", action="store_true")
    p.add_argument("--threedpw", action="store_true")
    p.add_argument("--amass_in", default=None)
    p.add_argument("--amass_out", default=None)
    p.add_argument("--threedpw_in", default=None)
    p.add_argument("--threedpw_out", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None):
    """Run the CLI; returns the ``ChunkedFK`` that did the FK (None when no
    corpus was asked for)."""
    p = parser()
    args = p.parse_args(argv)
    do_amass = args.amass or args.amass_in
    do_3dpw = args.threedpw or args.threedpw_in
    if not (do_amass or do_3dpw):
        p.print_help()
        return None
    fk = ChunkedFK(args.device)
    if do_amass:
        convert_amass_to_emr(args.amass_out or os.path.join(C.data_dir_synth(), "amass_emr", "corpus.emr"),
                             args.amass_in or os.path.join(C.data_dir_synth(), "amass"), fk=fk)
    if do_3dpw:
        convert_3dpw_to_emr(args.threedpw_out or os.path.join(C.data_dir_synth(), "3dpw_emr", "corpus.emr"),
                            args.threedpw_in or os.path.join(C.data_dir_synth(), "3dpw"), fk=fk)
    where = torch.cuda.get_device_name(fk.layer.device) if fk.layer.device.type == "cuda" else "cpu"
    print(f"FK: {fk.frames} frames in {fk.seconds:.3f} s on {where}")
    return fk


if __name__ == "__main__":
    main()
