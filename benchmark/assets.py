"""Everything a run is fed, made from its seed: a synthetic SMPL-H body
model, the subjects' sensor mounting offsets, the weights, pose windows and
recorded sensor sessions. The same seed gives the same inputs.

The body model has the licensed SMPL-H's keys, shapes, 52-joint tree and
mesh resolution (6890 vertices on a rolled grid, 13416 faces), with random
blend shapes, a random joint regressor and smooth skinning weights. Files
go under the run's temporary directory, which the program finds through
``SMPL_MODELS`` and ``EM_DATA_REAL``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import body as B

SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19)
SMPLH_PARENTS = (SMPL_PARENTS
                 + (20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35)
                 + (21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50))
GRID_ROWS, GRID_COLS = 130, 53
N_SUBJECTS = 4


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent host stream ``stream`` of ``seed`` (any size of seed)."""
    return np.random.default_rng([int(seed), stream])


def smplh_npz(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A synthetic SMPL-H with the AMASS npz keys."""
    n_v, n_j = GRID_ROWS * GRID_COLS, len(SMPLH_PARENTS)
    theta = np.linspace(0, 2 * np.pi, GRID_COLS, endpoint=False)
    z = np.linspace(0.0, 1.7, GRID_ROWS)
    tt, zz = np.meshgrid(theta, z)
    r = 0.25 + 0.05 * np.sin(3 * tt) * np.cos(2 * np.pi * zz / 1.7)
    verts = np.stack([r * np.cos(tt), r * np.sin(tt), zz], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(GRID_ROWS - 1), np.arange(GRID_COLS), indexing="ij")
    a, b = i * GRID_COLS + j, i * GRID_COLS + (j + 1) % GRID_COLS
    c, d = a + GRID_COLS, b + GRID_COLS
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 2).reshape(-1, 3)
    anchors = np.linspace(3, GRID_ROWS - 4, n_j).astype(int)
    jr = np.zeros((n_j, n_v))
    for k in range(n_j):
        jr[k, anchors[k] * GRID_COLS + rng.permutation(GRID_COLS)[:8]] = 1.0 / 8
    dist = np.abs(np.arange(n_v)[:, None] // GRID_COLS - anchors[None]).astype(np.float64)
    w = np.exp(-0.5 * (dist / 6.0) ** 2) + 1e-6
    kintree = np.stack([np.asarray([p if p >= 0 else 2 ** 32 - 1 for p in SMPLH_PARENTS]),
                        np.arange(n_j)]).astype(np.uint32)
    return {"v_template": verts, "shapedirs": rng.standard_normal((n_v, 3, 16)) * 0.01,
            "posedirs": rng.standard_normal((n_v, 3, (n_j - 1) * 9)) * 0.001,
            "J_regressor": jr, "weights": w / w.sum(1, keepdims=True),
            "kintree_table": kintree, "f": faces.astype(np.int32)}


def rotations(aa: np.ndarray) -> np.ndarray:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), float64."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)[..., None]
    k = aa / np.maximum(np.linalg.norm(aa, axis=-1, keepdims=True), 1e-12)
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def subject_offsets(rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """Mounting offset distributions of the subjects: per sensor a mean
    translation, its covariance and a rotation, in the recorded files' keys."""
    subjects = []
    for _ in range(N_SUBJECTS):
        a = rng.standard_normal((12, 3, 3)) * 0.005
        subjects.append({"means": rng.standard_normal((12, 3)) * 0.02,
                         "covs": np.einsum("mab,mcb->mac", a, a) + np.eye(3) * 1e-6,
                         "r": rotations(rng.standard_normal((12, 3)) * 0.1),
                         "vertex_ids": np.asarray(B.VERTEX_IDS, np.int64)})
    return subjects


def write_assets(root: str, npz: Dict, subjects: List[Dict]) -> None:
    """The body model and offset files where the program looks for them."""
    model_dir = os.path.join(root, "smpl_models", "smplh_amass", "neutral")
    real_dir = os.path.join(root, "data_real")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(real_dir, exist_ok=True)
    np.savez(os.path.join(model_dir, "model.npz"), **npz)
    for k, s in enumerate(subjects):
        np.savez(os.path.join(real_dir, f"s{k + 1:02d}_offsets.npz"), **s)
    os.environ["SMPL_MODELS"] = os.path.join(root, "smpl_models")
    os.environ["EM_DATA_REAL"] = real_dir


def offset_bank(subjects: List[Dict], device) -> Dict[str, torch.Tensor]:
    """The subjects' offsets as tensors: means, Cholesky factors, rotations."""
    stack = lambda k: np.stack([s[k] for s in subjects]).astype(np.float32)
    chol = np.linalg.cholesky(stack("covs").astype(np.float64)).astype(np.float32)
    return {"means": torch.tensor(stack("means"), device=device),
            "chol": torch.tensor(chol, device=device), "r": torch.tensor(stack("r"), device=device)}


def _quat(axis: int, angle: np.ndarray) -> np.ndarray:
    q = np.zeros(angle.shape + (4,))
    q[..., 0] = np.cos(angle / 2)
    q[..., 1 + axis] = np.sin(angle / 2)
    return q


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, v1, w2, v2 = a[..., :1], a[..., 1:], b[..., :1], b[..., 1:]
    return np.concatenate([w1 * w2 - (v1 * v2).sum(-1, keepdims=True),
                           w1 * v2 + w2 * v1 + np.cross(v1, v2)], -1)


def _angle_axis(q: np.ndarray) -> np.ndarray:
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    s = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    angle = 2 * np.arctan2(s, q[..., :1])
    return q[..., 1:] * np.where(s > 1e-12, angle / np.maximum(s, 1e-12), 2.0)


def pose_windows(rng: np.random.Generator, n: int, f: int) -> Dict[str, np.ndarray]:
    """``n`` smooth motions of ``f`` frames: every angle interpolates
    linearly between random control frames 16 frames apart. Body joints
    draw 0.4 rad a control frame; the root turns as a person does, about
    the body's long axis by up to 2 rad either way from where the motion
    starts, tilting by up to 0.3 rad, from a heading drawn at random. A
    random shape per motion and a small drifting translation."""
    k = f // 16 + 2
    t = np.arange(f) / 16.0
    lo = np.floor(t).astype(int)
    frac = (t - lo)[None, :, None]
    lerp = lambda c: c[:, lo] * (1 - frac) + c[:, lo + 1] * frac
    body = lerp(rng.standard_normal((n, k, 63)) * 0.4)
    steps = rng.standard_normal((n, k)) * 0.5
    steps[:, 0] = 0.0
    turn = np.clip(np.cumsum(steps, axis=1), -2.0, 2.0)
    tilt = np.clip(rng.standard_normal((n, k, 2)) * 0.15, -0.3, 0.3)
    ctrl = np.concatenate([turn[..., None], tilt], -1)
    yaw, pitch, roll = np.moveaxis(lerp(ctrl), -1, 0)
    yaw = yaw + rng.uniform(-np.pi, np.pi, (n, 1))
    q = _qmul(_qmul(_quat(2, yaw), _quat(0, roll)), _quat(1, pitch))
    poses = np.concatenate([_angle_axis(q), body], -1)
    trans = np.cumsum(rng.standard_normal((n, f, 3)) * 0.002, axis=1)
    return {"poses": poses.astype(np.float32), "trans": trans.astype(np.float32),
            "shapes": (rng.standard_normal((n, 10)) * 0.5).astype(np.float32),
            "seq_lengths": np.full(n, f, np.int32)}


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """A model's parameters and buffers from ``seed``, drawn on ``device`` in
    one call: each weight uniform in +-bound (BatchNorm scales in [0, 1)),
    BatchNorm shifts 0, PReLU slopes 0.25, running statistics fresh."""
    sizes = [int(np.prod(shape)) if init[0].startswith("uniform") else 0
             for _, shape, init in spec]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (key, shape, init), size in zip(spec, sizes):
        if init[0] == "uniform":
            out[key] = ((u[at:at + size] * 2 - 1) * init[1]).reshape(shape)
        elif init[0] == "uniform01":
            out[key] = u[at:at + size].reshape(shape).clone()
        elif init[0] == "count":
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            value = {"zeros": 0.0, "prelu": 0.25}.get(init[0], init[-1])
            out[key] = torch.full(shape, float(value), device=device)
        at += size
    return out


def is_parameter(init) -> bool:
    """Whether a spec entry is a trained parameter (not a running statistic)."""
    return init[0] not in ("buffer", "count")


def recorded_sessions(body: B.SensorBody, bank: Dict[str, torch.Tensor],
                      rng: np.random.Generator, n: int, f: int, device, block: int = 16384):
    """``n`` sessions of ``f`` frames of 12 sensors, as a recording would
    give them: smooth motions, root-normalized to their first frame, through
    the FK and the virtual sensors under one mounting offset per session
    drawn from its subject's distribution. Returns host arrays positions
    (n, f, 36) and orientations (n, f, 108), and the offsets the subject's
    files state, means (n, 12, 3) and rotations (n, 12, 3, 3)."""
    from benchmark.reference.common import normalize_root
    motion = pose_windows(rng, n, f)
    subject = rng.integers(0, bank["means"].shape[0], n)
    z = torch.tensor(rng.standard_normal((n, 12, 3)), dtype=torch.float32, device=device)
    s = torch.as_tensor(subject, device=device)
    means, r = bank["means"][s], bank["r"][s]
    local = means + (bank["chol"][s] @ z[..., None])[..., 0]
    pos = np.empty((n, f, 36), np.float32)
    ori = np.empty((n, f, 108), np.float32)
    with torch.no_grad():
        poses = normalize_root(torch.tensor(motion["poses"], device=device))
        shapes = torch.tensor(motion["shapes"], device=device)
        rows = max(1, block // f)
        for a in range(0, n, rows):
            b = min(n, a + rows)
            k = (b - a) * f
            betas = shapes[a:b, None].expand(b - a, f, 10).reshape(k, 10)
            verts, _ = B.fk(body, poses[a:b].reshape(k, 66), betas)
            p, fr = B.sensors(body, verts)
            fr = fr.reshape(b - a, f, 12, 3, 3)
            p = p.reshape(b - a, f, 12, 3) + (fr @ local[a:b, None, :, :, None])[..., 0]
            pos[a:b] = p.reshape(b - a, f, 36).cpu().numpy()
            ori[a:b] = (fr @ r[a:b, None]).reshape(b - a, f, 108).cpu().numpy()
    return pos, ori, means.cpu().numpy(), r.cpu().numpy()
