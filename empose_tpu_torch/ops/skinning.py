"""Full-mesh linear blend skinning: the CUDA kernel, its plain version, its count.

``csrc/lbs.cu`` replaces the Pallas TPU kernel
``empose_tpu/ops/skinning.py::lbs_apply_pallas``: per frame n and vertex v it
blends the joint transforms ``A[n]`` (12 x J, each joint's ``[R | t_skin]``
packed by :func:`pack_transforms`) with the vertex's LBS weights,
``T = A[n] @ W^T[:, v]``, and applies ``T`` at once,
``v' = T[0:9] as 3x3 . v_posed[n, v] + T[9:12]``, so the blended (N, V, 12)
transforms never reach device memory. The source says what bounds it on an
H100 and how it is tiled.

Contract shared by :func:`lbs_apply_plain` (weights (V, J), the JAX
package's ``lbs_apply_xla``) and :func:`lbs_apply_fused` (weights transposed,
(J, V)): ``R_glob`` (N, J, 3, 3), ``t_skin`` (N, J, 3), ``v_posed`` (N, V, 3)
-> skinned vertices (N, V, 3), all float32.

``lbs_apply_fused`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``LBS_LAUNCHES`` counts kernel launches.
:class:`FusedLBS` holds the transposed weights on a device, uploaded once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from empose_tpu_torch.ops import cuda_build

LBS_LAUNCHES = 0

NAME = "lbs"  # csrc/lbs.cu


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(NAME, {"lbs_forward": ([p, p, p, p, i, i, i, p], i)})


def pack_transforms(R_glob: torch.Tensor, t_skin: torch.Tensor) -> torch.Tensor:
    """(N, J, 3, 3) + (N, J, 3) -> (N, 12, J): per joint [R00..R22, t0..t2]."""
    n, j = t_skin.shape[0], t_skin.shape[1]
    return torch.cat([R_glob.reshape(n, j, 9), t_skin], dim=-1).transpose(1, 2)


def lbs_apply_plain(weights: torch.Tensor, R_glob: torch.Tensor, t_skin: torch.Tensor,
                    v_posed: torch.Tensor) -> torch.Tensor:
    """verts = (W R) v + W t with weights (V, J): the kernel's function in
    plain torch (``empose_tpu/ops/skinning.py::lbs_apply_xla``)."""
    Rw = torch.einsum("vj,njab->nvab", weights, R_glob)
    tw = torch.einsum("vj,nja->nva", weights, t_skin)
    return (Rw @ v_posed[..., None])[..., 0] + tw


def lbs_apply_fused(weights_t: torch.Tensor, R_glob: torch.Tensor, t_skin: torch.Tensor,
                    v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning with weights_t (J, V): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see module doc for the contract)."""
    global LBS_LAUNCHES
    if v_posed.device.type == "cpu":
        return lbs_apply_plain(weights_t.t(), R_glob, t_skin, v_posed)
    if v_posed.device.type != "cuda":
        raise ValueError(f"no LBS kernel for device {v_posed.device}")
    n, v = v_posed.shape[0], v_posed.shape[1]
    j = weights_t.shape[0]
    dev = v_posed.device
    for name, t, shape in (("weights_t", weights_t, (j, v)), ("R_glob", R_glob, (n, j, 3, 3)),
                           ("t_skin", t_skin, (n, j, 3)), ("v_posed", v_posed, (n, v, 3))):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    weights_t, v_posed = weights_t.contiguous(), v_posed.contiguous()
    a = pack_transforms(R_glob, t_skin).contiguous()
    out = torch.empty(n, v, 3, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lbs_forward(a.data_ptr(), weights_t.data_ptr(), v_posed.data_ptr(),
                               out.data_ptr(), n, j, v, stream)
    cuda_build.check(code, "LBS kernel")
    LBS_LAUNCHES += 1
    return out


class FusedLBS:
    """The transposed LBS weights (J, V) on ``device``, uploaded once, for
    repeated skinning calls (``empose_tpu/ops/skinning.py::PallasLBS``)."""

    def __init__(self, weights, device):
        self.weights_t = torch.as_tensor(np.ascontiguousarray(np.asarray(weights, np.float32).T),
                                         device=device)

    def __call__(self, R_glob: torch.Tensor, t_skin: torch.Tensor,
                 v_posed: torch.Tensor) -> torch.Tensor:
        """:param v_posed: (N, V, 3) -> (N, V, 3)."""
        return lbs_apply_fused(self.weights_t, R_glob, t_skin, v_posed)
