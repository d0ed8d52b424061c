"""Masked losses (port of ``empose_tpu/nn/losses.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def mask_from_seq_lengths(seq_lengths: torch.Tensor, max_seq_len: int) -> torch.Tensor:
    """(N,) lengths -> (N, S) float 0/1 mask."""
    t = torch.arange(max_seq_len, device=seq_lengths.device)[None, :]
    return (t < seq_lengths[:, None]).to(torch.float32)


def _frame_mask_from_marker_mask(marker_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(N, F, M) marker availability -> (N, F): a frame counts only when no
    marker is missing."""
    if marker_mask is None:
        return None
    return (~torch.any(marker_mask == 0, dim=-1)).to(torch.float32)


def reconstruction_loss(markers_gt: torch.Tensor, markers_hat: torch.Tensor,
                        seq_lengths: Optional[torch.Tensor] = None,
                        marker_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-marker L2 norm, summed over markers, masked mean over frames, mean
    over the batch. Inputs (N, F, M, D). Zero-length rows contribute 0."""
    diff = markers_hat - markers_gt
    per_sample = torch.sqrt((diff * diff).sum(-1)).sum(-1)  # (N, F)
    frame_mask = _frame_mask_from_marker_mask(marker_mask)
    if frame_mask is not None:
        per_sample = per_sample * frame_mask
    if seq_lengths is not None:
        mask = mask_from_seq_lengths(seq_lengths, per_sample.shape[1])
        per_sample = (per_sample * mask).sum(-1) / seq_lengths.clamp(min=1).to(per_sample.dtype)
    return per_sample.mean()


def padded_loss(gt: torch.Tensor, hat: torch.Tensor, elementwise_fn,
                seq_lengths: torch.Tensor) -> torch.Tensor:
    """Elementwise loss, mean over the last dim, masked mean over frames,
    mean over the batch. Zero-length rows contribute 0."""
    unreduced = elementwise_fn(gt, hat).mean(-1)  # (N, F)
    mask = mask_from_seq_lengths(seq_lengths, unreduced.shape[1])
    n_frames = seq_lengths.clamp(min=1).to(unreduced.dtype)
    return ((unreduced * mask).sum(-1) / n_frames).mean()


def l1(gt: torch.Tensor, hat: torch.Tensor) -> torch.Tensor:
    return (hat - gt).abs()


def mse(gt: torch.Tensor, hat: torch.Tensor) -> torch.Tensor:
    return (hat - gt).square()


def normal_mse(x_gt: torch.Tensor, x_hat: torch.Tensor,
               seq_lengths: Optional[torch.Tensor] = None,
               marker_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared error summed over dofs and joints, masked mean over frames,
    mean over the batch. Inputs (N, F, M, D)."""
    diff = x_hat - x_gt
    per_sample = (diff * diff).sum((-1, -2))  # (N, F)
    frame_mask = _frame_mask_from_marker_mask(marker_mask)
    if frame_mask is not None:
        per_sample = per_sample * frame_mask
    if seq_lengths is not None:
        mask = mask_from_seq_lengths(seq_lengths, per_sample.shape[1])
        per_sample = (per_sample * mask).sum(-1) / seq_lengths.clamp(min=1).to(per_sample.dtype)
    return per_sample.mean()
