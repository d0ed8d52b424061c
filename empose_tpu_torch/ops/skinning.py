"""Full-mesh linear blend skinning: the CUDA kernel, its plain version, its count.

``csrc/lbs.cu`` replaces the Pallas TPU kernel
``empose_tpu/ops/skinning.py::lbs_apply_pallas``: per frame n and vertex v it
blends the joint transforms ``[R_glob | t_skin]`` of frame n (12 x J) with
the vertex's LBS weights, ``T = A[n] @ W^T[:, v]``, and applies ``T`` at once,
``v' = T[0:9] as 3x3 . v_posed[n, v] + T[9:12]``, so the blended (N, V, 12)
transforms never reach device memory. The kernel reads ``R_glob`` and
``t_skin`` in place. The source says what bounds it on an H100 and how it is
tiled; :func:`lbs_launch_plan` sizes its grid.

Contract shared by :func:`lbs_apply_plain` (weights (V, J), the JAX
package's ``lbs_apply_xla``) and :func:`lbs_apply_fused` (weights transposed,
(J, V)): ``R_glob`` (N, J, 3, 3), ``t_skin`` (N, J, 3), ``v_posed`` (N, V, 3)
-> skinned vertices (N, V, 3), all float32.

``lbs_apply_fused`` checks its operands (device, float32, shape, contiguity:
a strided view raises ``ValueError``; it is not copied) on every device, then
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors; ``LBS_LAUNCHES`` counts kernel launches. :class:`FusedLBS` holds the
transposed weights on a device, uploaded once, and prepares the kernel there
once, so that a call does no setup and can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from empose_tpu_torch.ops import cuda_build
from empose_tpu_torch.ops.precision import matmul_at
from empose_tpu_torch.utils.precision import HIGHEST

LBS_LAUNCHES = 0

NAME = "lbs"  # csrc/lbs.cu

# The kernel's geometry, as csrc/lbs.cu fixes it: frames per pipeline stage
# and the vertex tiles it is compiled for (threads per block = tile_v); and
# the H100 SXM's SMs and the shared memory that the blocks of one SM share.
CHUNK = 8
TILES_V = (128, 32)
SM_SHARED_BYTES = 233472
SMS = 132

_prepared: Dict[int, int] = {}  # device index -> opt-in shared memory per block (bytes)
_lib = None  # the kernel's library, once lbs_prepare has loaded it


class LaunchPlan(NamedTuple):
    tile_v: int            # vertices per unit (and threads per block)
    blocks: int            # the grid, one dimension
    frames_per_block: int  # the most frames a block skins (its units x CHUNK)
    smem_bytes: int        # dynamic shared memory per block
    blocks_per_sm: int     # blocks an SM holds at once, by shared memory and threads


def lbs_smem_bytes(tile_v: int, j: int) -> int:
    """Shared memory of one block (``csrc/lbs.cu`` ``smem_floats``): the W^T
    tile, a chunk's transforms joint-major (12 J + 4 floats a frame), the
    next chunk's as they arrive (12 J a frame), and two stages of v_posed
    rows."""
    return 4 * (j * tile_v + CHUNK * (12 * j + 4) + CHUNK * 12 * j + 2 * CHUNK * tile_v * 3)


@functools.lru_cache(maxsize=256)
def lbs_launch_plan(n: int, v: int, j: int = 52) -> LaunchPlan:
    """Vertex tile and grid of the LBS kernel for N frames of a V-vertex mesh
    with J joints on an H100 (SMS streaming multiprocessors).

    The work is (vertex tile, chunk of CHUNK frames) units. The 128-vertex
    tile where that gives at least one unit per SM, else the 32-vertex tile
    (few frames: N <= 16 at the full mesh). Then as many blocks as the SMs
    hold at once, or one per unit if there are fewer units: each block takes
    an even share of the units in one wave, so no second, partial wave of
    blocks trails the first, and loads its W^T tile once per run of
    consecutive chunks."""
    if n <= 0 or v <= 0 or j <= 0:
        raise ValueError(f"LBS needs positive sizes, got N={n}, V={v}, J={j}")
    chunks = math.ceil(n / CHUNK)
    for tile_v in TILES_V:
        units = math.ceil(v / tile_v) * chunks
        if units >= SMS:
            break
    smem = lbs_smem_bytes(tile_v, j)
    per_sm = min(SM_SHARED_BYTES // (smem + 1024), 2048 // tile_v, 32)
    if per_sm < 1:
        raise ValueError(f"LBS at J={j} needs {smem} bytes of shared memory per block, more "
                         "than an SM has")
    blocks = min(units, per_sm * SMS)
    return LaunchPlan(tile_v, blocks, CHUNK * math.ceil(units / blocks), smem, per_sm)


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(NAME, {
        "lbs_prepare": ([i, ctypes.POINTER(i)], i),
        "lbs_forward": ([p, p, p, p, p, i, i, i, i, i, p], i),
    })


def lbs_prepare(device) -> None:
    """Once per device (``FusedLBS`` calls it): build the kernel if needed and
    set its shared-memory attributes there. Outside the per-call path, and
    outside any CUDA graph capture."""
    global _lib
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index in _prepared:
        return
    _lib = _library()
    max_smem = ctypes.c_int(0)
    cuda_build.check(_lib.lbs_prepare(index, ctypes.byref(max_smem)), "LBS kernel setup")
    _prepared[index] = max_smem.value


def pack_transforms(R_glob: torch.Tensor, t_skin: torch.Tensor) -> torch.Tensor:
    """(N, J, 3, 3) + (N, J, 3) -> (N, 12, J): per joint [R00..R22, t0..t2].
    The TPU kernel's operand; the CUDA kernel gathers it itself."""
    n, j = t_skin.shape[0], t_skin.shape[1]
    return torch.cat([R_glob.reshape(n, j, 9), t_skin], dim=-1).transpose(1, 2)


def lbs_apply_plain(weights: torch.Tensor, R_glob: torch.Tensor, t_skin: torch.Tensor,
                    v_posed: torch.Tensor, precision: str = HIGHEST) -> torch.Tensor:
    """verts = (W R) v + W t with weights (V, J): the kernel's function in
    plain torch (``empose_tpu/ops/skinning.py::lbs_apply_xla``), the blend
    product ``[R | t] @ W^T`` at ``precision`` (the kinematics knob's subset
    LBS; the full mesh stays at highest); the rotation of the vertices is
    f32."""
    n, j = R_glob.shape[:2]
    rt = torch.cat([R_glob.reshape(n, j, 9), t_skin], dim=-1).transpose(1, 2)  # (N, 12, J)
    blended = matmul_at(rt, weights.t(), precision)                             # (N, 12, V)
    Rw = blended[:, :9].transpose(1, 2).reshape(n, -1, 3, 3)
    return (Rw @ v_posed[..., None])[..., 0] + blended[:, 9:].transpose(1, 2)


def _check_operands(weights_t, R_glob, t_skin, v_posed) -> None:
    """Raise ValueError unless all four are contiguous float32 tensors on
    v_posed's device with the contract's shapes."""
    if v_posed.ndim != 3 or weights_t.ndim != 2:
        raise ValueError(f"v_posed must be (N, V, 3) and weights_t (J, V), got "
                         f"{tuple(v_posed.shape)} and {tuple(weights_t.shape)}")
    n, v = v_posed.shape[0], v_posed.shape[1]
    j = weights_t.shape[0]
    dev = v_posed.device
    for name, t, shape in (("weights_t", weights_t, (j, v)), ("R_glob", R_glob, (n, j, 3, 3)),
                           ("t_skin", t_skin, (n, j, 3)), ("v_posed", v_posed, (n, v, 3))):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}, got {t.dtype} on {t.device}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernel reads it in place), got "
                             f"strides {t.stride()}")


def lbs_apply_fused(weights_t: torch.Tensor, R_glob: torch.Tensor, t_skin: torch.Tensor,
                    v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning with weights_t (J, V): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see module doc for the contract)."""
    global LBS_LAUNCHES
    _check_operands(weights_t, R_glob, t_skin, v_posed)
    dev = v_posed.device
    if dev.type == "cpu":
        return lbs_apply_plain(weights_t.t(), R_glob, t_skin, v_posed)
    if dev.type != "cuda":
        raise ValueError(f"no LBS kernel for device {dev}")
    n, v = v_posed.shape[0], v_posed.shape[1]
    j = weights_t.shape[0]
    index = v_posed.get_device()
    if index not in _prepared:
        lbs_prepare(dev)
    plan = lbs_launch_plan(n, v, j)
    if plan.smem_bytes > _prepared[index]:
        raise ValueError(f"LBS at J={j} needs {plan.smem_bytes} bytes of shared memory per "
                         f"block; this card allows {_prepared[index]}")
    out = torch.empty_like(v_posed)
    # The raw stream and device queries: torch.cuda.current_stream() builds a
    # Stream object per call, host time that the launch would wait for.
    args = (R_glob.data_ptr(), t_skin.data_ptr(), weights_t.data_ptr(), v_posed.data_ptr(),
            out.data_ptr(), n, j, v, plan.tile_v, plan.blocks,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        code = _lib.lbs_forward(*args)
    else:
        with torch.cuda.device(index):
            code = _lib.lbs_forward(*args)
    cuda_build.check(code, "LBS kernel")
    LBS_LAUNCHES += 1
    return out


class FusedLBS:
    """The transposed LBS weights (J, V) on ``device``, uploaded once, for
    repeated skinning calls (``empose_tpu/ops/skinning.py::PallasLBS``); on a
    CUDA device the kernel is built and prepared here, once."""

    def __init__(self, weights, device):
        self.weights_t = torch.as_tensor(np.ascontiguousarray(np.asarray(weights, np.float32).T),
                                         device=device)
        if self.weights_t.device.type == "cuda":
            lbs_prepare(self.weights_t.device)

    def __call__(self, R_glob: torch.Tensor, t_skin: torch.Tensor,
                 v_posed: torch.Tensor) -> torch.Tensor:
        """:param v_posed: (N, V, 3) -> (N, V, 3)."""
        return lbs_apply_fused(self.weights_t, R_glob, t_skin, v_posed)
