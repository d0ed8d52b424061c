"""What both released models share: the sensor input, the masked losses,
the synthesis of a training batch from poses (root normalization, FK and
virtual sensors, mounting offsets drawn per sequence), Adam and one
training step.

A model module (``lgd.py``, ``rnn.py``) gives ``spec(flags)``,
``forward(p, body, window, flags, train, state, library)`` and
``loss(body, batch, out, flags)``; a configuration's file names its module
under ``reference``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import body as B

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def sensor_input(window: Dict, flags: Dict) -> torch.Tensor:
    """(N, F, 12*3) positions and (N, F, 12*9) orientations -> the network
    input (N, F, D): the 6-sensor subset where configured, positions then
    orientations."""
    n, f = window["marker_pos"].shape[:2]
    pos = window["marker_pos"].reshape(n, f, 12, 3)
    ori = window["marker_ori"].reshape(n, f, 12, 9)
    if flags["n_markers"] == 6:
        pos, ori = pos[:, :, list(B.SENSORS_6)], ori[:, :, list(B.SENSORS_6)]
    parts = []
    if flags.get("use_marker_pos"):
        parts.append(pos.reshape(n, f, -1))
    if flags.get("use_marker_ori"):
        parts.append(ori.reshape(n, f, -1))
    return torch.cat(parts, -1)


def frame_mask(lengths: torch.Tensor, f: int) -> torch.Tensor:
    return (torch.arange(f, device=lengths.device)[None] < lengths[:, None]).to(torch.float32)


def masked_mean(per_frame: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean over each sequence's valid frames, then over the batch."""
    m = frame_mask(lengths, per_frame.shape[1])
    return ((per_frame * m).sum(-1) / lengths.clamp(min=1).to(per_frame.dtype)).mean()


def l2_sum_loss(gt: torch.Tensor, hat: torch.Tensor, lengths) -> torch.Tensor:
    """(N, F, M, D): Euclidean distance per item, summed over items."""
    return masked_mean(torch.linalg.norm(hat - gt, dim=-1).sum(-1), lengths)


def l1_loss(gt: torch.Tensor, hat: torch.Tensor, lengths) -> torch.Tensor:
    """(N, F, D): absolute error averaged over D."""
    return masked_mean((hat - gt).abs().mean(-1), lengths)


def sq_loss(gt: torch.Tensor, hat: torch.Tensor, lengths) -> torch.Tensor:
    """(N, F, M, D): squared error summed over M and D."""
    return masked_mean(((hat - gt) ** 2).sum((-1, -2)), lengths)


def normalize_root(poses: torch.Tensor) -> torch.Tensor:
    """Rotate every frame's root by the inverse of frame 0's root."""
    root = poses[:, :, :3]
    inv = B.exp_map(root[:, 0]).transpose(-1, -2)[:, None]
    return torch.cat([B.log_map(inv @ B.exp_map(root)), poses[:, :, 3:]], -1)


def draw_offsets(bank: Dict[str, torch.Tensor], n: int, generator: torch.Generator):
    """One subject per sequence and standard normals (N, 12, 3), in the
    order the training step draws them."""
    dev = bank["means"].device
    subject = torch.randint(0, bank["means"].shape[0], (n,), generator=generator, device=dev)
    z = torch.randn((n, bank["means"].shape[1], 3), generator=generator, device=dev)
    return subject, z


def synthesize(body: B.SensorBody, bank: Dict[str, torch.Tensor], batch: Dict,
               generator: torch.Generator) -> Dict:
    """A training batch from poses (N, F, 66), shapes (N, 10) and lengths:
    the root normalized to frame 0 with no translation, the virtual sensors
    under one mounting offset per sequence drawn from its subject's
    distribution; the subject's mean offsets are what the model is told."""
    poses = normalize_root(batch["poses"])
    n, f = poses.shape[:2]
    betas = batch["shapes"][:, None].expand(n, f, -1).reshape(n * f, -1)
    verts, joints = B.fk(body, poses.reshape(n * f, -1), betas)
    pos, frame = B.sensors(body, verts)
    subject, z = draw_offsets(bank, n, generator)
    means, r = bank["means"][subject], bank["r"][subject]
    local = means + (bank["chol"][subject] @ z[..., None])[..., 0]           # (N, 12, 3)
    frame = frame.reshape(n, f, 12, 3, 3)
    pos = pos.reshape(n, f, 12, 3) + (frame @ local[:, None, :, :, None])[..., 0]
    ori = frame @ r[:, None]
    return {"poses": poses, "shapes": batch["shapes"], "seq_lengths": batch["seq_lengths"],
            "joints_gt": joints.reshape(n, f, -1), "marker_pos": pos.reshape(n, f, -1),
            "marker_ori": ori.reshape(n, f, -1), "offset_t": means, "offset_r": r}


def train_step(mod, p: Dict[str, torch.Tensor], names, adam: Dict, body, bank, batch: Dict,
               flags: Dict, generator: torch.Generator) -> Tuple[float, Dict]:
    """One step in place on the leaves ``names`` of ``p``: synthesize, the
    train forward and loss, the gradients, Adam (bias-corrected, eps outside
    the square root). Returns the loss and the gradients by leaf."""
    leaves = [p[k].detach().requires_grad_() for k in names]
    q = dict(p, **dict(zip(names, leaves)))
    data = synthesize(body, bank, batch, generator)
    out, _ = mod.forward(q, body, data, flags, train=True)
    total, extra = mod.loss(body, data, out, flags)
    grads = torch.autograd.grad(total + extra, leaves, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for w, g in zip(leaves, grads)]
    adam["t"] += 1
    b1, b2 = ADAM_BETAS
    lr = flags["lr"]
    with torch.no_grad():
        for k, g in zip(names, grads):
            m = adam["m"].setdefault(k, torch.zeros_like(g))
            v = adam["v"].setdefault(k, torch.zeros_like(g))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** adam["t"])
            v_hat = v / (1 - b2 ** adam["t"])
            p[k] = p[k] - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    return float(total.detach()), dict(zip(names, grads))
