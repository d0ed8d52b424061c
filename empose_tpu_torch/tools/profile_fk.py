"""Sub-component timing of the subset FK + sensor synthesis (port of
``tools/profile_fk.py``).

Splits one ``SensorSMPL.estimated_markers`` call into its parts: the
Rodrigues map, the rigid-transform chain, the blendshapes and the subset
LBS, the sensor frames and the offset apply. Each part is one of the
functions below, the same arithmetic as ``estimated_markers`` (chained, they
give its markers bit for bit); the products run in fp32 with TF32 off, the
JAX tool's HIGHEST. No LSTM or LBS kernel is involved.

    python -m empose_tpu_torch.tools.profile_fk [--rows 2048] [--device cpu]

Each part's time is the best of ``repeats`` blocks (``utils/profiling.timeit_ms``).
Runs on CUDA unless ``--device cpu``; ``main`` returns the rows (ms, calls)
as a dict and prints the JAX tool's lines.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import _rigid_transform_chain
from empose_tpu_torch.data import virtual_sensors as vsens
from empose_tpu_torch.device import precision_scope, resolve_device
from empose_tpu_torch.nn.models import SensorSMPL
from empose_tpu_torch.ops.skinning import lbs_apply_plain
from empose_tpu_torch.ops.so3 import rodrigues
from empose_tpu_torch.tools.profile_common import device_name, synthetic_smplh
from empose_tpu_torch.utils.profiling import chain_calls, timeit_ms

PARTS = ("rodrigues", "rigid chain", "blendshapes + LBS", "sensor frames", "offset apply")


def rodrigues_part(sub, pose: torch.Tensor) -> torch.Tensor:
    """(N, 66) poses, zero hand joints appended -> (N, J, 3, 3) rotations."""
    n = pose.shape[0]
    full_pose = torch.cat([pose, pose.new_zeros(n, (sub.n_joints - C.N_JOINTS - 1) * 3)], -1)
    return rodrigues(full_pose.reshape(n, sub.n_joints, 3))


def rest_joints(sub, shape: torch.Tensor) -> torch.Tensor:
    """(N, 10) shapes -> (N, J, 3) rest joints."""
    n, nb = shape.shape
    return sub.j_template[None] + (shape @ sub.j_shapedirs.reshape(-1, nb).t()).reshape(n, -1, 3)


def chain_part(sub, rot_mats: torch.Tensor, j_rest: torch.Tensor):
    """-> (posed joints, global rotations, skinning translations)."""
    return _rigid_transform_chain(rot_mats, j_rest, sub.parents)


def blend_lbs_part(sub, rot_mats, shape, R_glob, t_skin) -> torch.Tensor:
    """Shape and pose blendshapes, then the subset LBS -> (N, V_sub, 3)."""
    n, nb = shape.shape
    v_rest = sub.v_template[None] + (shape @ sub.shapedirs.reshape(-1, nb).t()).reshape(n, -1, 3)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(n, -1)
    v_posed = v_rest + (pose_feature @ sub.posedirs).reshape(n, -1, 3)
    return lbs_apply_plain(sub.weights, R_glob, t_skin, v_posed)


def offset_part(pos, ori, offset_r, offset_t):
    """Mounting offsets on the sensor frames -> (marker_pos, marker_ori)."""
    return pos + (ori @ offset_t[..., None])[..., 0], ori @ offset_r


def inputs(rng: np.random.RandomState, rows: int, device) -> Dict[str, torch.Tensor]:
    """Poses, shapes and offsets of ``rows`` frames, as the JAX tool draws them."""
    pose = rng.randn(rows, 66).astype(np.float32) * 0.2
    shape = rng.randn(rows, 10).astype(np.float32) * 0.2
    offset_t = rng.randn(rows, 12, 3).astype(np.float32) * 0.02
    offset_r = np.broadcast_to(np.eye(3, dtype=np.float32), (rows, 12, 3, 3)).copy()
    return {k: torch.from_numpy(v).to(device) for k, v in
            dict(pose=pose, shape=shape, offset_r=offset_r, offset_t=offset_t).items()}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.profile_fk")
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    return p


def main(argv: Optional[list] = None, iters: int = 30, warmup: int = 3, repeats: int = 3) -> Dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    nf = args.rows
    depth = dict(iters=iters, warmup=warmup, repeats=repeats)
    calls = chain_calls(**depth)
    rows = {}

    def timed(name, fn, *fn_args):
        rows[name] = {"ms": timeit_ms(fn, *fn_args, **depth), "calls": calls}

    with precision_scope("highest"), torch.no_grad():
        sensor = SensorSMPL(synthetic_smplh()).to(dev)
        sub, tables = sensor._sub_model(), sensor._tables()
        x = inputs(np.random.RandomState(0), nf, dev)
        pose, shape, offset_r, offset_t = x["pose"], x["shape"], x["offset_r"], x["offset_t"]

        timed("rodrigues", rodrigues_part, sub, pose)
        rot_mats = rodrigues_part(sub, pose)
        j_rest = rest_joints(sub, shape)
        timed("rigid chain", chain_part, sub, rot_mats, j_rest)
        _, R_glob, t_skin = chain_part(sub, rot_mats, j_rest)
        timed("blendshapes + LBS", blend_lbs_part, sub, rot_mats, shape, R_glob, t_skin)
        verts = blend_lbs_part(sub, rot_mats, shape, R_glob, t_skin)
        timed("sensor frames", vsens.virtual_pos_and_rot, verts, tables)
        pos, ori, _ = vsens.virtual_pos_and_rot(verts, tables)
        timed("offset apply", offset_part, pos, ori, offset_r, offset_t)
        timed("estimated_markers (all)", sensor.estimated_markers, pose, shape, offset_r,
              offset_t)

    print(f"rows={nf} on {device_name(dev)}")
    print(f"estimated_markers (all): {rows['estimated_markers (all)']['ms']:7.3f} ms")
    for name in PARTS:
        print(f"  {name:21s}: {rows[name]['ms']:7.3f} ms")
    return rows


if __name__ == "__main__":
    main()
