"""Sensor-fault augmentation: spherical displacement and marker suppression
(port of ``empose_tpu/data/noise.py``).

``make_noise_fn`` picks at most one noise type from the configuration and
returns ``noise(batch, generator) -> batch``. Each noise is split in two, as
the offsets of ``data/transforms.py`` are: a function that draws from the
``torch.Generator`` on the batch's device, and a function that takes the
draws as arguments, so that a test can hand it the JAX package's draws.
Nothing is copied to the host: the window arithmetic, the gates and the
thigh length stay on the device, and the early exits read shapes only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from empose_tpu_torch import constants as C


def make_noise_fn(config, randomize_if_configured: bool, is_valid: bool = False):
    """``noise(batch, generator) -> batch``: at most one noise type.

    Training (``randomize_if_configured``) takes spherical noise where its
    length is > 0, else suppression noise where its length is > 0; both at
    once raises ``ValueError``. Validation (``is_valid``) keeps suppression
    noise if configured; everything else is the identity.
    """
    def no_noise(batch, generator):
        return batch

    def suppression():
        return marker_suppression_noise_fn(config.suppression_noise_length,
                                           config.noise_num_markers,
                                           config.suppression_noise_value, config.n_markers)

    if randomize_if_configured:
        if config.spherical_noise_length > 0.0:
            if config.suppression_noise_length > 0.0:
                raise ValueError("Only one noise type at a time.")
            return spherical_marker_noise_fn(config.spherical_noise_strength,
                                             config.spherical_noise_length,
                                             config.noise_num_markers)
        if config.suppression_noise_length > 0.0:
            return suppression()
        return no_noise
    if is_valid and config.suppression_noise_length > 0.0:
        return suppression()
    return no_noise


def _clamp01(x: float) -> float:
    return min(max(0.0, x), 1.0)


def _valid_lengths(batch: Dict, n: int, f: int, device) -> torch.Tensor:
    lengths = batch.get("seq_lengths")
    if lengths is None:
        return torch.full((n,), f, dtype=torch.int64, device=device)
    return torch.as_tensor(lengths, device=device)


def _window_gate(valid: torch.Tensor, ws: float, u: torch.Tensor, f: int) -> torch.Tensor:
    """(N, F) bool: frames [start, start + len) of each entry, with
    ``len = floor(ws * valid)`` and ``start = floor(u * (valid - len + 1))``,
    both in float32 as in JAX."""
    window_len = torch.floor(ws * valid.to(torch.float32)).to(torch.int64)
    sf = torch.floor(u * (valid - window_len + 1).to(torch.float32)).to(torch.int64)
    t = torch.arange(f, device=valid.device)[None, :]
    return (t >= sf[:, None]) & (t < (sf + window_len)[:, None])


def spherical_marker_noise_fn(sphere_size: float, window_size: float, num_markers: int):
    """Random spherical displacement of K markers over a random window of
    each entry: ``noise(batch, generator)``."""
    max_r, ws = _clamp01(sphere_size), _clamp01(window_size)
    if max_r > 0.0 and ws <= 0.0:
        raise ValueError("Temporal length of spherical marker noise is 0.0 but strength is > 0.0.")

    def apply(batch: Dict, generator: torch.Generator) -> Dict:
        if max_r <= 0.0 or "marker_pos" not in batch \
                or int(ws * batch["marker_pos"].shape[1]) == 0:
            return batch
        n, f, width = batch["marker_pos"].shape
        draws = draw_spherical_noise(n, f, width // 3, num_markers, generator,
                                     batch["marker_pos"].device)
        return spherical_marker_noise(batch, draws, max_r, ws)

    return apply


def draw_spherical_noise(n: int, f: int, m: int, num_markers: int, generator: torch.Generator,
                         device) -> Dict[str, torch.Tensor]:
    """The draws of :func:`spherical_marker_noise`: a permutation of the
    ``m`` markers (m,), the window start's uniform (N,), and the radius',
    azimuth's and polar angle's uniforms (N, F, K)."""
    kw = dict(generator=generator, device=device)
    return {"perm": torch.randperm(m, **kw), "u": torch.rand((n,), **kw),
            "r": torch.rand((n, f, num_markers), **kw),
            "theta": torch.rand((n, f, num_markers), **kw),
            "phi": torch.rand((n, f, num_markers), **kw)}


def spherical_marker_noise(batch: Dict, draws: Dict[str, torch.Tensor], max_r: float,
                           ws: float) -> Dict:
    """Displace the chosen markers inside each entry's window (``max_r``
    and ``ws`` clamped to [0, 1], and the early exits taken, by the
    caller)."""
    markers = batch["marker_pos"]
    n, f = markers.shape[0], markers.shape[1]
    m = markers.shape[-1] // 3
    ms = markers.reshape(n, f, m, 3)
    k = draws["r"].shape[-1]
    # Quirk kept: one permutation, truncated to K, shared by every entry.
    m_ids = draws["perm"][:k]
    valid = _valid_lengths(batch, n, f, markers.device)
    in_window = _window_gate(valid, ws, draws["u"], f)

    # Quirk kept: the radius is scaled by batch entry 0's thigh length.
    # A 6-sensor batch has no marker RLL: JAX clamps the index to the last.
    rul = min(C.T_TO_IDX_WO_ROOT[C.T_RUL], m - 1)
    rll = min(C.T_TO_IDX_WO_ROOT[C.T_RLL], m - 1)
    thigh_len = torch.linalg.vector_norm(ms[0, f // 2, rul] - ms[0, 0, rll])
    r = draws["r"] * max_r * thigh_len / 2
    thetas = draws["theta"] * np.pi * 2
    phis = draws["phi"] * np.pi
    # Quirk kept: ys takes cos(phi) where a sphere would take sin(phi).
    disp = torch.stack([r * torch.cos(thetas) * torch.sin(phis),
                        r * torch.sin(thetas) * torch.cos(phis),
                        r * torch.cos(phis)], dim=-1)  # (N, F, K, 3)

    target = torch.zeros((m,), dtype=torch.bool, device=markers.device).scatter_(0, m_ids, True)
    gate = in_window[:, :, None] & target[None, None, :]  # (N, F, M)
    disp_full = torch.zeros_like(ms).scatter_(2, m_ids[None, None, :, None].expand_as(disp), disp)
    out = dict(batch)
    out["marker_pos"] = torch.where(gate[..., None], ms + disp_full, ms).reshape(n, f, -1)
    return out


def _candidates(n_markers_in: int) -> tuple:
    if n_markers_in not in (6, 12):
        raise ValueError(f"n_markers must be 6 or 12, got {n_markers_in}")
    return C.S_CONFIG_6 if n_markers_in == 6 else tuple(range(12))


def marker_suppression_noise_fn(window_size: float, num_markers: int, mask_value: float,
                                n_markers_in: int = 12):
    """Set K random markers (position, orientation, normal) of each entry to
    ``mask_value`` over a random window: ``noise(batch, generator)``."""
    candidates = _candidates(n_markers_in)
    ws = _clamp01(window_size)

    def apply(batch: Dict, generator: torch.Generator) -> Dict:
        markers = batch["marker_pos"]
        choice, u = draw_suppression_noise(markers.shape[0], num_markers, len(candidates),
                                           generator, markers.device)
        return marker_suppression_noise(batch, choice, u, ws, mask_value, n_markers_in)

    return apply


def draw_suppression_noise(n: int, num_markers: int, n_candidates: int,
                           generator: torch.Generator, device):
    """The draws of :func:`marker_suppression_noise`: candidate indices
    (N, K) and the window start's uniform (N,)."""
    kw = dict(generator=generator, device=device)
    return (torch.randint(0, n_candidates, (n, num_markers), **kw), torch.rand((n,), **kw))


def marker_suppression_noise(batch: Dict, choice: torch.Tensor, u: torch.Tensor, ws: float,
                             mask_value: float, n_markers_in: int = 12) -> Dict:
    """Mask the chosen markers inside each entry's window. ``choice`` (N, K)
    indexes the candidates: ``S_CONFIG_6`` for a 6-sensor model, else all
    12. ``marker_masks`` is left as it is (as in JAX)."""
    markers = batch["marker_pos"]
    n, f = markers.shape[0], markers.shape[1]
    m = markers.shape[-1] // 3
    # An asynchronous copy: the host does not wait for the device.
    candidates = torch.tensor(_candidates(n_markers_in)).to(markers.device, non_blocking=True)
    # Quirk kept: K markers drawn with replacement, so fewer may be masked.
    m_ids = candidates[choice]  # (N, K)
    valid = _valid_lengths(batch, n, f, markers.device)
    in_window = _window_gate(valid, ws, u, f)
    target = torch.zeros((n, m), dtype=torch.bool, device=markers.device)
    target.scatter_(1, m_ids, True)
    gate = in_window[:, :, None] & target[:, None, :]  # (N, F, M)

    out = dict(batch)
    out["marker_pos"] = markers.reshape(n, f, m, 3).masked_fill(
        gate[..., None], mask_value).reshape(n, f, -1)
    out["marker_ori"] = batch["marker_ori"].reshape(n, f, m, 3, 3).masked_fill(
        gate[..., None, None], mask_value).reshape(n, f, -1)
    out["marker_nor"] = batch["marker_nor"].reshape(n, f, m, 3).masked_fill(
        gate[..., None], mask_value).reshape(n, f, -1)
    return out
