"""Weight-resident LSTM inference: the CUDA kernels, their plain versions, their counts.

Two kernels, each replacing a Pallas TPU kernel of
``empose_tpu/ops/lstm_kernel.py``; each source file says what bounds it on an
H100 and how the weights are spread over the SMs:

* ``csrc/lstm_stack.cu`` replaces ``_pallas_forward``: the inference forward
  of a whole unidirectional L-layer LSTM stack over F steps in one launch,
  with every layer's gate weights resident on chip for the whole sweep;
* ``csrc/lstm_bidi.cu`` replaces ``_pallas_bidi``: one bidirectional layer,
  both directions in one launch with both recurrent weights resident.

Contract shared by :func:`lstm_stack_plain` and :func:`lstm_stack_fused`
(time-major, the JAX kernel's layouts):

* ``x0_proj`` (F, N, 4H): layer 0's input projection with both biases;
* ``mask`` (F, N): 1.0 at valid steps, 0.0 at padded ones;
* ``w_hh`` (L, H, 4H), ``w_ih_up`` (L-1, H, 4H), ``b_up`` (L-1, 4H), the
  weights transposed to ``x @ w`` form, gate order (i, f, g, o);
* ``h0``/``c0`` (L, N, H).

Both return ``(outs (F, N, H), hF (L, N, H), cF (L, N, H))``: the last
layer's outputs, zero at masked steps, and the final states, frozen bit for
bit at masked steps.

``lstm_stack_fused`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``LAUNCHES`` counts kernel launches. The libraries
are compiled with ``nvcc`` at first use into ``empose_tpu_torch/_build/``.

The wavefront schedule (``_pallas_wavefront``, entry
``lstm_stack_pallas_wavefront``) has the same contract and results: layer l
steps at time t - l in phase t, so a launch runs F + L - 1 phases (grid
barriers) instead of F * L. :func:`lstm_stack_wavefront_plain` computes it in
that order, deeper layers' gates as one product ``[out_{l-1}, h_l] @ [W_ih;
W_hh] + b``; :func:`lstm_stack_wavefront_fused` launches the stack kernel's
wavefront entry (``csrc/lstm_stack.cu``) for CUDA tensors and runs the plain
version for CPU tensors; ``WAVEFRONT_LAUNCHES`` counts its launches. Both
need at least 2 layers.

Contract shared by :func:`lstm_bidi_plain` and :func:`lstm_bidi_fused` (the
JAX kernel's, time-major):

* ``x_proj`` (F, 2, N, 4H): each direction's input projection with both
  biases, the backward one projected from the input reversed per sample by
  length, so that ``mask`` (F, N) serves both directions;
* ``w_hh2`` (2, H, 4H), [fwd, bwd] in ``x @ w`` form; ``h0``/``c0`` (2, N, H).

Both return ``(outs (F, 2, N, H), hF (2, N, H), cF (2, N, H))``, the backward
outputs still in reversed time, zero at masked steps; the final states frozen
bit for bit at masked steps. ``lstm_bidi_fused`` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; ``BIDI_LAUNCHES`` counts
its launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from empose_tpu_torch.ops import cuda_build

LAUNCHES = 0
BIDI_LAUNCHES = 0
WAVEFRONT_LAUNCHES = 0

NAME = "lstm_stack"  # csrc/lstm_stack.cu
BIDI_NAME = "lstm_bidi"  # csrc/lstm_bidi.cu


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    stack_args = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    return cuda_build.load(NAME, {
        "lstm_stack_forward": (stack_args, i),
        "lstm_wavefront_forward": (stack_args, i),
        "lstm_stack_units": ([i], i),
    })


def _bidi_library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(BIDI_NAME, {
        "lstm_bidi_forward": ([p, p, p, p, p, p, p, i, i, i, p], i),
        "lstm_bidi_units": ([i], i),
    })


def _sigmoid_tanh_cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_plain(x_proj: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor):
    """One LSTM direction over time (``nn/layers.py::_lstm_cell_scan``).

    :param x_proj: (F, N, 4H) input projection with biases; :param mask: (F, N).
    :return: (outputs (F, N, H) zeroed at masked steps, hF, cF).
    """
    h, c = h0, c0
    outs = []
    for t in range(x_proj.shape[0]):
        h_new, c_new = _sigmoid_tanh_cell(x_proj[t] + h @ w_hh, c)
        m = mask[t][:, None]
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        outs.append(h_new * m)
    return torch.stack(outs), h, c


def lstm_stack_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0):
    """The kernel's function in plain torch, layer by layer (see module doc)."""
    xp = x0_proj
    hs, cs = [], []
    for l in range(w_hh.shape[0]):
        if l > 0:
            xp = outs @ w_ih_up[l - 1] + b_up[l - 1]
        outs, hF, cF = lstm_cell_plain(xp, mask, w_hh[l], h0[l], c0[l])
        hs.append(hF)
        cs.append(cF)
    return outs, torch.stack(hs), torch.stack(cs)


def _check(name: str, t: Optional[torch.Tensor], shape: Tuple[int, ...], device) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_stack(entry: str, what: str, x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0):
    """Check the stack's operands and launch ``entry`` of ``csrc/lstm_stack.cu``."""
    if x0_proj.device.type != "cuda":
        raise ValueError(f"no {what} for device {x0_proj.device}")
    f, n, h4 = x0_proj.shape
    num_layers, hidden = w_hh.shape[0], w_hh.shape[1]
    dev = x0_proj.device
    _check("x0_proj", x0_proj, (f, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh", w_hh, (num_layers, hidden, 4 * hidden), dev)
    if num_layers > 1:
        _check("w_ih_up", w_ih_up, (num_layers - 1, hidden, 4 * hidden), dev)
        _check("b_up", b_up, (num_layers - 1, 4 * hidden), dev)
    _check("h0", h0, (num_layers, n, hidden), dev)
    _check("c0", c0, (num_layers, n, hidden), dev)
    lib = _library()
    outs = torch.empty(f, n, hidden, device=dev)
    hbuf = torch.empty(2, num_layers, n, hidden, device=dev)
    hbuf[0].copy_(h0)
    c_state = c0.clone()
    h_final = torch.empty(num_layers, n, hidden, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            x0_proj.data_ptr(), mask.data_ptr(), w_hh.data_ptr(),
            w_ih_up.data_ptr() if num_layers > 1 else None,
            b_up.data_ptr() if num_layers > 1 else None,
            outs.data_ptr(), hbuf.data_ptr(), c_state.data_ptr(), h_final.data_ptr(),
            f, n, hidden, num_layers, stream)
    cuda_build.check(code, what)
    return outs, h_final, c_state


def lstm_stack_fused(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0):
    """The stack forward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see module doc for the contract)."""
    global LAUNCHES
    if x0_proj.device.type == "cpu":
        return lstm_stack_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0)
    out = _launch_stack("lstm_stack_forward", "LSTM stack kernel", x0_proj, mask, w_hh, w_ih_up,
                        b_up, h0, c0)
    LAUNCHES += 1
    return out


def _need_two_layers(num_layers: int) -> None:
    if num_layers < 2:
        raise ValueError("wavefront schedule needs >= 2 layers "
                         "(use lstm_stack for a single layer)")


def lstm_stack_wavefront_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0):
    """The wavefront kernel's function in plain torch, in its order: in
    phase t every layer l with 0 <= t - l < F steps at time t - l; a deeper
    layer's input is the output its predecessor made in the previous phase
    (see module doc)."""
    num_layers, f = w_hh.shape[0], x0_proj.shape[0]
    _need_two_layers(num_layers)
    w_cat = [torch.cat([w_ih_up[l - 1], w_hh[l]]) for l in range(1, num_layers)]
    h, c = list(h0.unbind(0)), list(c0.unbind(0))
    pipe = [None] * (num_layers - 1)  # layer l's output of the previous phase
    outs = []
    for t in range(f + num_layers - 1):
        new_pipe = list(pipe)
        for l in range(max(0, t - f + 1), min(num_layers - 1, t) + 1):
            s = t - l
            if l == 0:
                gates = x0_proj[s] + h[0] @ w_hh[0]
            else:
                gates = torch.cat([pipe[l - 1], h[l]], dim=-1) @ w_cat[l - 1] + b_up[l - 1]
            h_new, c_new = _sigmoid_tanh_cell(gates, c[l])
            m = mask[s][:, None]
            h[l] = torch.where(m > 0, h_new, h[l])
            c[l] = torch.where(m > 0, c_new, c[l])
            if l < num_layers - 1:
                new_pipe[l] = h_new * m
            else:
                outs.append(h_new * m)
        pipe = new_pipe
    return torch.stack(outs), torch.stack(h), torch.stack(c)


def lstm_stack_wavefront_fused(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0):
    """The stack forward in the wavefront schedule: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (see module doc)."""
    global WAVEFRONT_LAUNCHES
    _need_two_layers(w_hh.shape[0])
    if x0_proj.device.type == "cpu":
        return lstm_stack_wavefront_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0)
    out = _launch_stack("lstm_wavefront_forward", "LSTM wavefront kernel", x0_proj, mask, w_hh,
                        w_ih_up, b_up, h0, c0)
    WAVEFRONT_LAUNCHES += 1
    return out


def stack_operands(cells: List[dict], x: torch.Tensor):
    """Hoisted layer-0 projection and stacked weights of a unidirectional
    stack, as ``empose_tpu/ops/lstm_kernel.py::lstm_stack_pallas`` builds them.

    :param cells: L dicts of w_ih (I|H, 4H), w_hh (H, 4H), b_ih, b_hh (4H,).
    :param x: (F, N, I).
    :return: (x0_proj (F, N, 4H), w_hh (L, H, 4H), w_ih_up, b_up) with
      ``w_ih_up``/``b_up`` None for a single layer.
    """
    x0_proj = x @ cells[0]["w_ih"] + cells[0]["b_ih"] + cells[0]["b_hh"]
    w_hh = torch.stack([c["w_hh"] for c in cells]).contiguous()
    if len(cells) == 1:
        return x0_proj.contiguous(), w_hh, None, None
    w_ih_up = torch.stack([c["w_ih"] for c in cells[1:]]).contiguous()
    b_up = torch.stack([c["b_ih"] + c["b_hh"] for c in cells[1:]]).contiguous()
    return x0_proj.contiguous(), w_hh, w_ih_up, b_up


def lstm_stack(cells: List[dict], x, mask, h0, c0, stack_fn=lstm_stack_fused):
    """Same contract as ``empose_tpu/ops/lstm_kernel.py::lstm_stack_pallas``:
    ``x`` (F, N, I), ``mask`` (F, N), ``h0``/``c0`` (L, N, H) ->
    (outputs (F, N, H), (hF, cF))."""
    x0_proj, w_hh, w_ih_up, b_up = stack_operands(cells, x)
    outs, hF, cF = stack_fn(x0_proj, mask.contiguous(), w_hh, w_ih_up, b_up,
                            h0.contiguous(), c0.contiguous())
    return outs, (hF, cF)


def lstm_stack_wavefront(cells: List[dict], x, mask, h0, c0,
                         stack_fn=lstm_stack_wavefront_fused):
    """Same contract and errors as
    ``empose_tpu/ops/lstm_kernel.py::lstm_stack_pallas_wavefront``: the
    results of :func:`lstm_stack`; ``ValueError`` below 2 layers (raised by
    ``stack_fn``)."""
    return lstm_stack(cells, x, mask, h0, c0, stack_fn)


def lstm_bidi_plain(x_proj, mask, w_hh2, h0, c0):
    """The bidirectional kernel's function in plain torch, one direction after
    the other (see module doc)."""
    outs, hs, cs = [], [], []
    for d in range(2):
        o, hF, cF = lstm_cell_plain(x_proj[:, d], mask, w_hh2[d], h0[d], c0[d])
        outs.append(o)
        hs.append(hF)
        cs.append(cF)
    return torch.stack(outs, dim=1), torch.stack(hs), torch.stack(cs)


def lstm_bidi_fused(x_proj, mask, w_hh2, h0, c0):
    """One bidirectional layer: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see module doc for the contract)."""
    global BIDI_LAUNCHES
    if x_proj.device.type == "cpu":
        return lstm_bidi_plain(x_proj, mask, w_hh2, h0, c0)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no bidirectional LSTM kernel for device {x_proj.device}")
    f, n, hidden = x_proj.shape[0], x_proj.shape[2], w_hh2.shape[1]
    dev = x_proj.device
    _check("x_proj", x_proj, (f, 2, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh2", w_hh2, (2, hidden, 4 * hidden), dev)
    _check("h0", h0, (2, n, hidden), dev)
    _check("c0", c0, (2, n, hidden), dev)
    lib = _bidi_library()
    outs = torch.empty(f, 2, n, hidden, device=dev)
    hbuf = torch.empty(2, 2, n, hidden, device=dev)
    hbuf[0].copy_(h0)
    c_state = c0.clone()
    h_final = torch.empty(2, n, hidden, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lstm_bidi_forward(
            x_proj.data_ptr(), mask.data_ptr(), w_hh2.data_ptr(), outs.data_ptr(),
            hbuf.data_ptr(), c_state.data_ptr(), h_final.data_ptr(), f, n, hidden, stream)
    cuda_build.check(code, "bidirectional LSTM kernel")
    BIDI_LAUNCHES += 1
    return outs, h_final, c_state


def lstm_bidi_layer(cell_fwd: dict, cell_bwd: dict, x_fwd, x_bwd, mask, h0, c0,
                    bidi_fn=lstm_bidi_fused):
    """Same contract as ``empose_tpu/ops/lstm_kernel.py::lstm_bidi_layer_pallas``:
    ``x_fwd`` (F, N, I) and ``x_bwd``, the same input reversed per sample by
    length; ``mask`` (F, N); ``h0``/``c0`` (2, N, H) [fwd, bwd] ->
    (outs (F, 2, N, H), the backward outputs in reversed time, (hF, cF))."""
    xp_f = x_fwd @ cell_fwd["w_ih"] + cell_fwd["b_ih"] + cell_fwd["b_hh"]
    xp_b = x_bwd @ cell_bwd["w_ih"] + cell_bwd["b_ih"] + cell_bwd["b_hh"]
    x_proj = torch.stack([xp_f, xp_b], dim=1)
    w_hh2 = torch.stack([cell_fwd["w_hh"], cell_bwd["w_hh"]])
    outs, hF, cF = bidi_fn(x_proj, mask.contiguous(), w_hh2, h0.contiguous(), c0.contiguous())
    return outs, (hF, cF)
