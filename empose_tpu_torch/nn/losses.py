"""Masked losses the LGD loop reads (port of ``empose_tpu/nn/losses.py:10-72``)."""

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
