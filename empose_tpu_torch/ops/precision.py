"""The products of the three matmul precision modes.

``HIGHEST`` is an fp32 product with TF32 off. ``DEFAULT`` rounds both
operands to bf16 (round to nearest even) and accumulates and returns f32, as
``jnp.dot(..., precision=DEFAULT, preferred_element_type=f32)`` on the MXU.
``HIGH`` is the bf16_3x product ``ah@bh + al@bh + ah@bl`` of the operands'
bf16 hi/lo splits (``split_bf16``), accumulated in f32: ``dot3`` of
``empose_tpu/ops/lstm_kernel.py``. On CUDA the bf16 products are
``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS on the tensor cores, f32
output). On the CPU they are fp32 GEMMs of the bf16 values: a product of two
bf16 values is exact in fp32, so this computes the same function up to the
order of the f32 sums; it is the plain version.

A weight's bf16 form (its rounding at DEFAULT, its hi/lo split at HIGH) is
made once and kept while the weight is unchanged (:func:`derived`), as JAX
splits the weights outside its kernels.

:func:`matmul_at` is differentiable: its backward takes the two products at
the same mode, as JAX transposes a DEFAULT or HIGH dot into dots at the
same precision (autograd through dtype casts would not).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from empose_tpu_torch.utils.precision import DEFAULT, HIGH, HIGHEST, resolve

# Mode codes of the CUDA kernels' C entries (csrc/lstm_common.cuh kHighest, ...).
MODE_CODES = {HIGHEST: 0, HIGH: 1, DEFAULT: 2}

# derived(): key -> (the sources' version counters when it was made, the value).
_DERIVED: Dict[tuple, tuple] = {}


def derived(tag: str, srcs: Sequence[torch.Tensor], make: Callable):
    """``make()``, a function of the weights ``srcs``, made once and kept
    while they are unchanged. The entry is keyed on ``tag`` and on each
    source's place in the tensor it is a view of (its owner); it is dropped
    when an owner is freed and made anew when a source's version counter
    has moved (an in-place update; a write through ``.data`` is not seen).
    Nothing is kept for inference tensors (they have no version counter),
    for sources that autograd tracks (the value would carry their graph) or
    while a CUDA graph is being captured (its kernels have not run yet)."""
    if any(t.is_inference() or (t.requires_grad and torch.is_grad_enabled()) for t in srcs) or (
            srcs[0].is_cuda and torch.cuda.is_current_stream_capturing()):
        return make()
    owners = [t if t._base is None else t._base for t in srcs]
    key = (tag,) + tuple((id(o), t.storage_offset(), tuple(t.shape), t.stride(), t.dtype,
                          t.device) for o, t in zip(owners, srcs))
    versions = tuple(t._version for t in srcs)
    hit = _DERIVED.get(key)
    if hit is not None and hit[0] == versions:
        return hit[1]
    if hit is None:
        for owner in {id(o): o for o in owners}.values():
            weakref.finalize(owner, _DERIVED.pop, key, None)
    value = make()
    _DERIVED[key] = (versions, value)
    return value


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-to-bf16 hi/lo split: x ~= hi + lo with one bf16 rounding each
    (``x.astype(jnp.bfloat16)``, round to nearest even)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def bf16_parts(x: torch.Tensor, mode: str) -> Tuple[torch.Tensor, ...]:
    """An operand as the products at DEFAULT or HIGH take it, made anew
    (an activation's): ``(bf16(x),)`` at DEFAULT, its ``split_bf16`` pair at
    HIGH."""
    return (x.to(torch.bfloat16),) if mode == DEFAULT else split_bf16(x)


def weight_parts(w: torch.Tensor, mode: str) -> Tuple[torch.Tensor, ...]:
    """A weight as the products at DEFAULT or HIGH take it: ``(bf16(w),)``
    at DEFAULT, its ``split_bf16`` pair at HIGH; made once per weight
    (:func:`derived`)."""
    return derived(mode, (w,), lambda: bf16_parts(w, mode))


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) of bf16 matrices with f32 sums and an f32 result."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


def dot3(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """The HIGH product of a 2-D ``a`` with a pre-split weight: ``a`` splits
    per call, ``(ah@wh + al@wh) + ah@wl`` in f32 (``dot3`` of the JAX
    package, the same order of the three sums)."""
    a_hi, a_lo = split_bf16(a)
    return mm_bf16(a_hi, w_hi) + mm_bf16(a_lo, w_hi) + mm_bf16(a_hi, w_lo)


def product_at(a: torch.Tensor, b_parts: Tuple[torch.Tensor, ...], mode: str) -> torch.Tensor:
    """``a @ b`` of a 2-D ``a`` at DEFAULT or HIGH, ``b`` given by its
    :func:`bf16_parts` (or :func:`weight_parts`); ``a`` is rounded or split
    per call."""
    if mode == DEFAULT:
        return mm_bf16(a.to(torch.bfloat16), b_parts[0])
    return dot3(a, *b_parts)


class _MatmulAt(torch.autograd.Function):
    """(..., K) @ (K, N) at DEFAULT or HIGH, both gradients at the same mode."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return product_at(a.reshape(-1, a.shape[-1]), weight_parts(b, mode),
                        mode).reshape(*a.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g2 = grad.reshape(-1, grad.shape[-1])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = product_at(g2, weight_parts(b.t(), ctx.mode), ctx.mode).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            gb = product_at(a.reshape(-1, a.shape[-1]).t(), bf16_parts(g2, ctx.mode), ctx.mode)
        return ga, gb, None


def matmul_at(a: torch.Tensor, b: torch.Tensor, mode: str = HIGHEST) -> torch.Tensor:
    """``a @ b`` for ``a`` (..., K) and a weight ``b`` (K, N) at precision
    ``mode`` (see module doc); HIGHEST is the plain fp32 ``a @ b``."""
    mode = resolve(mode)
    if mode == HIGHEST:
        return a @ b
    return _MatmulAt.apply(a, b, mode)
