"""Weight-resident LSTM inference: the CUDA kernels, their plain versions, their counts.

Two kernels, each replacing a Pallas TPU kernel of
``empose_tpu/ops/lstm_kernel.py``; each source file says what bounds it on an
H100 and how the weights are spread over the SMs:

* ``csrc/lstm_stack.cu`` replaces ``_pallas_forward``: the inference forward
  of a whole unidirectional L-layer LSTM stack over F steps in one launch,
  with every layer's gate weights resident on chip for the whole sweep;
* ``csrc/lstm_bidi.cu`` replaces ``_pallas_bidi``: one bidirectional layer,
  both directions in one launch (or one launch per direction) with the
  recurrent weights resident.

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
version for CPU tensors; ``LAUNCHES`` counts kernel launches. Its setup is
out of the per-call path: :func:`lstm_stack_prepare` sets the kernel's
shared memory and checks its occupancy once per device, and
:func:`lstm_stack_plan` (pure Python) sizes the grid and the staged rows;
``MODE_LAUNCHES`` counts every kernel's launches by precision;
h0 and c0 are read in place, so a call can be captured in a CUDA graph. The
libraries are compiled with ``nvcc`` at first use into
``empose_tpu_torch/_build/``.

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
its kernel launches: one per layer where both directions fit on the card in
one grid (H=512), two (one per direction) where they do not (H=1024). Its
setup is out of the per-call path: :func:`lstm_bidi_prepare` sets the
kernel's shared memory and checks its occupancy once per device, and
:func:`lstm_bidi_plan` (pure Python) sizes the grid and the staged rows.

Every function here takes ``precision`` (``utils/precision.py``; default
``highest``), the mode of the JAX kernels' ``precision`` argument: at
``highest`` the products are fp32; at ``default`` bf16 inputs with f32
sums; at ``high`` the bf16_3x product of JAX's ``dot3`` (``ops/precision.py``).
The plain versions compute them with ``ops/precision.py``; the kernels run
the recurrent products (and the stack's in-kernel input products) on the
tensor cores at ``high`` and ``default``, with the weights rounded or split
by the wrapper, as JAX pre-splits them outside its kernel. The hoisted
input projections go through ``matmul_at`` at the same mode.

Any H the models take runs at inference: where the whole stack does not fit
in one launch on the card at hand (:func:`lstm_stack_fits` with the card's
SMs and shared memory, :func:`stack_limits`; at H=1024 with 2 layers, or at
2x512 on a card with fewer than 128 SMs), :func:`lstm_stack` runs it one
layer per launch of the same kernel, layer l > 0's input projection one GEMM
outside. The wavefront schedule (the bench tool's only) keeps needing the
whole stack in one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from empose_tpu_torch.ops import cuda_build
from empose_tpu_torch.ops.precision import MODE_CODES, derived, matmul_at, weight_parts
from empose_tpu_torch.utils.precision import HIGH, HIGHEST, resolve

LAUNCHES = 0
BIDI_LAUNCHES = 0
WAVEFRONT_LAUNCHES = 0
# The same launches by (kernel, precision): ("lstm_stack" | "lstm_wavefront" |
# "lstm_bidi", "highest" | "high" | "default") -> count.
MODE_LAUNCHES: Dict[Tuple[str, str], int] = {}


def _count(kernel: str, mode: str) -> None:
    key = (kernel, mode)
    MODE_LAUNCHES[key] = MODE_LAUNCHES.get(key, 0) + 1

NAME = "lstm_stack"  # csrc/lstm_stack.cu
BIDI_NAME = "lstm_bidi"  # csrc/lstm_bidi.cu

# The kernels' geometry, as their sources fix it (threads per block, rows of
# a staged chunk of h, the most ring slots), and the H100 SXM's SMs and
# opt-in shared memory per block.
THREADS = 256
PASS_ROWS = 16
MAX_SLOTS = 8
SMS = 132
SMEM_LIMIT = 232448

_stack_prepared: Dict[int, Tuple[int, int]] = {}  # device index -> (SMs, opt-in shared bytes)
_stack_lib = None  # the stack kernel's library, once lstm_stack_prepare has loaded it
_bidi_prepared: Dict[int, Tuple[int, int]] = {}  # device index -> (SMs, opt-in shared bytes)
_bidi_lib = None  # the bidirectional kernel's library, once lstm_bidi_prepare has loaded it


def _stack_library():
    p, i = ctypes.c_void_p, ctypes.c_int
    stack_args = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p]
    return cuda_build.load(NAME, {
        "lstm_stack_prepare": ([i, ctypes.POINTER(i)], i),
        "lstm_stack_forward": (stack_args, i),
        "lstm_wavefront_forward": (stack_args, i),
    })


def _bidi_library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(BIDI_NAME, {
        "lstm_bidi_prepare": ([i, ctypes.POINTER(i)], i),
        "lstm_bidi_forward": ([p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p], i),
        "lstm_bidi_smem_bytes": ([i, i, i, i], ctypes.c_longlong),
    })


def _launch(fn, index: int, *args) -> int:
    """Call a C entry on device ``index``'s current raw stream, switching the
    current device only where it differs."""
    args = (*args, torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def units_per_block(h: int, max_blocks: int) -> int:
    """The smallest power of two U (at most 8) that divides H with H / U <=
    ``max_blocks``; 0 where there is none."""
    return next((u for u in (1, 2, 4, 8) if h % u == 0 and h // u <= max_blocks), 0)


class StackPlan(NamedTuple):
    """The stack kernel's launch plan (:func:`lstm_stack_plan`). The kernel
    takes every field as given and only checks that it is valid: the plan
    alone decides. At high and default (``ring_body``, both orders) the
    kernel reads ``units``, ``stage_rows`` (its ring's slots), ``teams`` (of
    4 warps), ``planes`` (the most items a chunk of a phase has, which two
    teams need more slots than) and ``smem_bytes``."""
    units: int       # hidden units per block (U) of every layer: 4, or 8 where H / 4 blocks
                     # do not fit on the SMs
    blocks: int      # the cooperative grid, H / U, one block per SM
    planes: int      # layer states staged per phase: 2 (1 for one layer) in the stack
                     # order, L in the wavefront order
    stage_rows: int  # rows of each staged state in shared memory: N (all at once), or
                     # fewer: a ring of stage_rows / PASS_ROWS slots that the PASS_ROWS-row
                     # chunks cycle through; at high and default PASS_ROWS x the ring's
                     # slots, each one state's bf16 chunk that bulk copies fill
    teams: int       # teams that take the chunks in turns: at highest teams of 256 threads
                     # (the block's size), each with its share of the ring: 2 at U=4 (1 for
                     # one chunk, N <= 16, where the ring has one slot, or where two teams'
                     # slots do not fit), 1 at U=8; at high and default teams of 4 warps in
                     # a block of 8 (2 where N > 16 and the ring has more slots than a
                     # chunk has items, ``planes``, else 1 of 8 warps)
    smem_bytes: int  # dynamic shared memory per block


MMA_WARPS = 8  # warps of a team that split a product's k-steps at high and default
# Bytes of a mode body's ring sync block (csrc/lstm_common.cuh kRingSyncBytes):
# a full and an empty mbarrier for each of MAX_SLOTS slots and the count of
# the chunks issued, to 16 bytes.
RING_SYNC_BYTES = 2 * MAX_SLOTS * 8 + 16


def _bf16_parts(precision: str) -> int:
    """bf16 planes of an operand at a mode: 1 (default), 2 (high: hi and lo)."""
    return 2 if resolve(precision) == HIGH else 1


def _mma_bytes(units: int, h: int, precision: str):
    """(one matrix's resident B fragments, the partial tiles of 8 warps) in
    bytes at high or default (``csrc/lstm_common.cuh``)."""
    return (_bf16_parts(precision) * 8 * units * (-(-h // 16) * 16),
            MMA_WARPS * PASS_ROWS * 4 * units * 4)


def stack_smem_bytes(units: int, h: int, layers: int, planes: int, stage_rows: int) -> int:
    """Shared memory of one stack-kernel block at highest
    (``csrc/lstm_stack.cu`` ``smem_floats``): the resident fp32 gate columns
    of every W_hh and of W_ih of layers >= 1 (each to 128 bytes), and
    ``planes`` staged states of ``stage_rows`` rows (at high and default:
    :func:`stack_ring_smem_bytes`)."""
    return 4 * ((2 * layers - 1) * (-(-4 * units * h // 32) * 32) + planes * stage_rows * h)


def stack_ring_smem_bytes(units: int, h: int, layers: int, stages: int, precision: str) -> int:
    """Shared memory of one stack-kernel block at high and default, in both
    orders (``csrc/lstm_stack.cu`` ``ring_smem_bytes``): the bf16 B
    fragments of the 2L - 1 matrices, a ring of ``stages`` slots of one
    state's 16-row chunk in bf16 k-step tiles (hi, and lo at high), the
    ring's mbarriers and the count of its items issued (RING_SYNC_BYTES)
    and two buffers of the partial tiles."""
    mat, partial = _mma_bytes(units, h, precision)
    return ((2 * layers - 1) * mat + stages * _bf16_parts(precision) * -(-h // 16) * 16
            * PASS_ROWS * 2 + RING_SYNC_BYTES + 2 * partial)


def stack_exchange_shape(layers: int, n: int, h: int, precision: str) -> Tuple[int, ...]:
    """The stack kernel's bf16 exchange buffer at high and default, in both
    orders: (slots 2, layers, parts (2 at high), 16-row chunks of N, k-steps
    of H padded to 16, a 16x16 tile)."""
    return (2, layers, _bf16_parts(precision), -(-n // PASS_ROWS), -(-h // 16), PASS_ROWS * 16)


@functools.lru_cache(maxsize=256)
def lstm_stack_plan(layers: int, n: int, h: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                    wavefront: bool = False, precision: str = HIGHEST) -> StackPlan:
    """Launch plan of the stack kernel (``csrc/lstm_stack.cu``) for an
    L-layer stack, N rows, hidden size H, in the stack order or (with
    ``wavefront``) the wavefront order.

    Each block owns U units of every layer, one block per SM: U=4 where H / 4
    blocks fit on the SMs (2x512: 128 blocks with 96 KB of columns), else U=8
    for one layer (one layer of 1024: 128 blocks, 128 KB; the columns of two
    such layers leave no room for a slot). A phase stages the states of up
    to ``planes`` layers; all N rows of each where they fit beside the
    columns (2x512: N <= 32), else the PASS_ROWS-row chunks cycle through a
    ring of as many slots as fit (at most MAX_SLOTS; 2x512: 2, one layer of
    1024: 1), so the shared memory stops growing with N and any N has a plan.
    At U=4 two teams of 256 threads take the chunks in turns, each with half
    of the ring (an odd slot count loses a slot), where there are two chunks
    or more and the ring has two slots or more. Raises ValueError where no U
    puts the grid on the SMs or not one slot fits beside the columns
    (2x1024).

    At high and default the grid is the same, in both orders. One state's
    16-row bf16 chunk a slot streams through a ring of as many slots as fit
    beside the B fragments, up to MAX_SLOTS and a phase's items: ``planes``
    a chunk at most (two states from 2 layers on in the stack order, L in
    the wavefront order, each staged once); 2x512 N=64 8 at default, 3 at
    high; one layer of 1024 N=64 4 and 1; ``stage_rows`` is PASS_ROWS x the
    slots, and two teams of 4 warps take the chunks in turns where a phase
    has two chunks or more and the ring more slots than a chunk has items
    (from two layers 3 in the stack order, L + 1 in the wavefront order; 2
    at one layer: with fewer, thread 0, which issues the copies after its
    own products, would not reach its team's next chunk)."""
    if layers <= 0 or n <= 0 or h <= 0 or h % 4:
        raise ValueError(f"the stack kernel needs L > 0, N > 0 and H a positive multiple of 4, "
                         f"got L={layers}, N={n}, H={h}")
    if wavefront and layers < 2:
        raise ValueError("wavefront schedule needs >= 2 layers "
                         "(use lstm_stack for a single layer)")
    units = next((u for u in (4, 8) if h % u == 0 and h // u <= sms), 0)
    if units == 8 and layers > 1:
        units = 0  # U=8 runs one layer (at H > 4 SMs no slot fits beside two layers' columns)
    planes = layers if wavefront else min(layers, 2)
    rows, teams = n, 2 if units == 4 and n > PASS_ROWS else 1
    if resolve(precision) != HIGHEST:
        chunks = -(-n // PASS_ROWS)
        stages = 0
        if units:
            fixed = stack_ring_smem_bytes(units, h, layers, 0, precision)
            slot = stack_ring_smem_bytes(units, h, layers, 1, precision) - fixed
            stages = min(MAX_SLOTS, chunks * planes, max(0, smem_limit - fixed) // slot)
        if not stages:
            raise ValueError(f"the stack kernel at L={layers}, N={n}, H={h}, precision "
                             f"{precision} does not fit on {sms} SMs with {smem_limit} bytes "
                             "of shared memory per block")
        return StackPlan(units, h // units, planes, PASS_ROWS * stages,
                         2 if chunks > 1 and stages > planes else 1,
                         stack_ring_smem_bytes(units, h, layers, stages, precision))
    if units and stack_smem_bytes(units, h, layers, planes, n) > smem_limit:
        free = smem_limit - stack_smem_bytes(units, h, layers, planes, 0)
        slots = min(MAX_SLOTS, max(0, free) // (4 * PASS_ROWS * planes * h))
        teams = min(teams, max(slots, 1))
        rows = PASS_ROWS * (slots - slots % teams)  # each team its share of the ring
    if not units or rows < 1:
        raise ValueError(f"the stack kernel at L={layers}, N={n}, H={h} does not fit on {sms} "
                         f"SMs with {smem_limit} bytes of shared memory per block")
    return StackPlan(units, h // units, planes, rows, teams,
                     stack_smem_bytes(units, h, layers, planes, rows))


def lstm_stack_fits(layers: int, h: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                    precision: str = HIGHEST) -> bool:
    """Whether the stack kernel runs an L-layer stack at hidden size H in one
    launch for every N at ``precision`` on a card with ``sms`` SMs and
    ``smem_limit`` bytes of opt-in shared memory per block:
    :func:`lstm_stack_plan` has a plan with one PASS_ROWS-row slot (on an
    H100 SXM, at 2 layers: H=512 yes, H=1024 no, at every mode; one layer of
    1024 yes; on a 114-SM H100 PCIe, 2x512 no)."""
    try:
        lstm_stack_plan(layers, PASS_ROWS, h, sms, smem_limit, precision=precision)
    except ValueError:
        return False
    return True


def _sigmoid_tanh_cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_plain(x_proj: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor, precision: str = HIGHEST):
    """One LSTM direction over time (``nn/layers.py::_lstm_cell_scan``), the
    recurrent product at ``precision``.

    :param x_proj: (F, N, 4H) input projection with biases; :param mask: (F, N).
    :return: (outputs (F, N, H) zeroed at masked steps, hF, cF).
    """
    h, c = h0, c0
    outs = []
    for t in range(x_proj.shape[0]):
        h_new, c_new = _sigmoid_tanh_cell(x_proj[t] + matmul_at(h, w_hh, precision), c)
        m = mask[t][:, None]
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        outs.append(h_new * m)
    return torch.stack(outs), h, c


def lstm_stack_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, precision: str = HIGHEST):
    """The kernel's function in plain torch, layer by layer (see module doc)."""
    xp = x0_proj
    hs, cs = [], []
    for l in range(w_hh.shape[0]):
        if l > 0:
            xp = matmul_at(outs, w_ih_up[l - 1], precision) + b_up[l - 1]
        outs, hF, cF = lstm_cell_plain(xp, mask, w_hh[l], h0[l], c0[l], precision)
        hs.append(hF)
        cs.append(cF)
    return outs, torch.stack(hs), torch.stack(cs)


def _check(name: str, t: Optional[torch.Tensor], shape: Tuple[int, ...], device) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got {t.dtype} on {t.device}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _limits(device, prepared: Dict[int, Tuple[int, int]], prepare) -> Tuple[int, int]:
    device = torch.device(device)
    if device.type != "cuda":
        return SMS, SMEM_LIMIT
    index = _device_index(device)
    if index not in prepared:
        prepare(device)
    return prepared[index]


def stack_limits(device) -> Tuple[int, int]:
    """(SMs, opt-in shared bytes per block) that the stack kernel plans with
    on ``device``: a CUDA device's own (:func:`lstm_stack_prepare` reads
    them once), the H100 SXM's constants elsewhere (the CPU plans of the
    tests)."""
    return _limits(device, _stack_prepared, lstm_stack_prepare)


def bidi_limits(device) -> Tuple[int, int]:
    """The same for the bidirectional layer kernel (:func:`lstm_bidi_prepare`)."""
    return _limits(device, _bidi_prepared, lstm_bidi_prepare)


def lstm_stack_prepare(device) -> None:
    """Once per device (the wrappers call it at their first launch there):
    build the stack kernel if needed, set the shared memory of its nine
    instances (U=4 in the stack and the wavefront order, U=8 in the stack
    order, at each mode) and check their occupancy. Outside the per-call path, and outside
    any CUDA graph capture."""
    global _stack_lib
    index = _device_index(device)
    if index in _stack_prepared:
        return
    _stack_lib = _stack_library()
    info = (ctypes.c_int * 2)()
    cuda_build.check(_stack_lib.lstm_stack_prepare(index, info), "LSTM stack kernel setup")
    _stack_prepared[index] = (info[0], info[1])


def kernel_weights(w: torch.Tensor, mode: str):
    """A weight as a kernel takes it at high or default: (bf16(w), None) at
    default, the bf16 (hi, lo) pair at high; made once per weight
    (``ops/precision.weight_parts``)."""
    parts = weight_parts(w, mode)
    return parts[0], parts[1] if len(parts) > 1 else None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_stack(wavefront: bool, what: str, x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0,
                  mode: str):
    """Check the stack's operands and launch ``csrc/lstm_stack.cu`` in the
    stack or the wavefront order at ``mode`` (a resolved name), as
    :func:`lstm_stack_plan` says. At highest the weights go in as they are;
    at high and default in their bf16 form (:func:`kernel_weights`), with a
    bf16 exchange buffer that each launch fills itself
    (:func:`stack_exchange_shape`). No setup after the first call on
    a device, no copy of h0/c0 (read in place) and no synchronization, so
    the call can be captured in a CUDA graph."""
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
    index = x0_proj.get_device()
    if mode == HIGHEST:
        plan = lstm_stack_plan(num_layers, n, hidden, *stack_limits(dev), wavefront)
        w_hh_lo = w_ih_up_lo = None
    else:
        plan = lstm_stack_plan(num_layers, n, hidden, *stack_limits(dev), wavefront, mode)
        w_hh, w_hh_lo = kernel_weights(w_hh, mode)
        w_ih_up, w_ih_up_lo = kernel_weights(w_ih_up, mode) if num_layers > 1 else (None, None)
    # The kernel copies h0's rows 16 bytes at a time.
    h0 = h0 if h0.data_ptr() % 16 == 0 else h0.clone()
    outs = torch.empty(f, n, hidden, device=dev)
    # The state apart from the outputs, so that a caller keeping only (hF, cF)
    # keeps no more: the h exchange buffer (2, L) and cF (L), each plane on a
    # 16-byte boundary (H % 4 == 0).
    state = torch.empty(3 * num_layers, n, hidden, device=dev)
    xbuf = None if mode == HIGHEST else torch.empty(
        stack_exchange_shape(num_layers, n, hidden, mode), dtype=torch.bfloat16, device=dev)
    ptr = state.data_ptr()
    entry = _stack_lib.lstm_wavefront_forward if wavefront else _stack_lib.lstm_stack_forward
    code = _launch(entry, index, x0_proj.data_ptr(), mask.data_ptr(), w_hh.data_ptr(),
                   _ptr(w_ih_up), b_up.data_ptr() if num_layers > 1 else None, h0.data_ptr(),
                   c0.data_ptr(), outs.data_ptr(), ptr, ptr + 4 * 2 * num_layers * n * hidden, f,
                   n, hidden, num_layers, plan.units, plan.stage_rows, plan.teams,
                   plan.smem_bytes, MODE_CODES[mode], _ptr(w_hh_lo), _ptr(w_ih_up_lo),
                   _ptr(xbuf))
    cuda_build.check(code, what)
    h_last = num_layers * (f & 1)  # h after the last step: hbuf[F & 1]
    return outs, state[h_last:h_last + num_layers], state[2 * num_layers:]


def lstm_stack_fused(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, precision: str = HIGHEST):
    """The stack forward at ``precision``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (see module doc for the contract)."""
    global LAUNCHES
    if x0_proj.device.type == "cpu":
        return lstm_stack_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, precision)
    mode = resolve(precision)
    out = _launch_stack(False, "LSTM stack kernel", x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0,
                        mode)
    LAUNCHES += 1
    _count("lstm_stack", mode)
    return out


def _need_two_layers(num_layers: int) -> None:
    if num_layers < 2:
        raise ValueError("wavefront schedule needs >= 2 layers "
                         "(use lstm_stack for a single layer)")


def lstm_stack_wavefront_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0,
                               precision: str = HIGHEST):
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
                gates = x0_proj[s] + matmul_at(h[0], w_hh[0], precision)
            else:
                gates = matmul_at(torch.cat([pipe[l - 1], h[l]], dim=-1), w_cat[l - 1],
                                  precision) + b_up[l - 1]
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


def lstm_stack_wavefront_fused(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0,
                               precision: str = HIGHEST):
    """The stack forward in the wavefront schedule at ``precision``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors (see module
    doc)."""
    global WAVEFRONT_LAUNCHES
    _need_two_layers(w_hh.shape[0])
    if x0_proj.device.type == "cpu":
        return lstm_stack_wavefront_plain(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, precision)
    mode = resolve(precision)
    out = _launch_stack(True, "LSTM wavefront kernel", x0_proj, mask, w_hh, w_ih_up, b_up, h0,
                        c0, mode)
    WAVEFRONT_LAUNCHES += 1
    _count("lstm_wavefront", mode)
    return out


def _stacked(tensors: List[torch.Tensor], precision: str) -> torch.Tensor:
    """``torch.stack(tensors)``; at high and default kept per weight set
    (``ops/precision.derived``), so that the kernels' bf16 form of it is
    made once."""
    if resolve(precision) == HIGHEST:
        return torch.stack(tensors)
    return derived("stack", tensors, lambda: torch.stack(tensors))


def stack_operands(cells: List[dict], x: torch.Tensor, precision: str = HIGHEST):
    """Hoisted layer-0 projection (at ``precision``) and stacked weights of a
    unidirectional stack, as ``empose_tpu/ops/lstm_kernel.py::lstm_stack_pallas``
    builds them.

    :param cells: L dicts of w_ih (I|H, 4H), w_hh (H, 4H), b_ih, b_hh (4H,).
    :param x: (F, N, I).
    :return: (x0_proj (F, N, 4H), w_hh (L, H, 4H), w_ih_up, b_up) with
      ``w_ih_up``/``b_up`` None for a single layer.
    """
    x0_proj = matmul_at(x, cells[0]["w_ih"], precision) + cells[0]["b_ih"] + cells[0]["b_hh"]
    w_hh = _stacked([c["w_hh"] for c in cells], precision)
    if len(cells) == 1:
        return x0_proj.contiguous(), w_hh, None, None
    w_ih_up = _stacked([c["w_ih"] for c in cells[1:]], precision)
    b_up = torch.stack([c["b_ih"] + c["b_hh"] for c in cells[1:]]).contiguous()
    return x0_proj.contiguous(), w_hh, w_ih_up, b_up


def lstm_stack(cells: List[dict], x, mask, h0, c0, stack_fn=lstm_stack_fused,
               precision: str = HIGHEST):
    """Same contract as ``empose_tpu/ops/lstm_kernel.py::lstm_stack_pallas``:
    ``x`` (F, N, I), ``mask`` (F, N), ``h0``/``c0`` (L, N, H) ->
    (outputs (F, N, H), (hF, cF)), every product at ``precision``.

    The whole stack goes to ``stack_fn`` in one call where it fits in one
    launch on ``x``'s device (:func:`lstm_stack_fits` with
    :func:`stack_limits`, the (SMs, shared bytes) the launch plans with);
    otherwise one layer per call, layer l > 0's input projection one
    GEMM outside, as layer 0's is. (:func:`lstm_stack_wavefront`, run by the
    bench tool only, needs the whole stack in one launch.)"""
    x0_proj, w_hh, w_ih_up, b_up = stack_operands(cells, x, precision)
    mask, h0, c0 = mask.contiguous(), h0.contiguous(), c0.contiguous()
    if lstm_stack_fits(len(cells), w_hh.shape[1], *stack_limits(x.device), precision=precision):
        outs, hF, cF = stack_fn(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, precision)
        return outs, (hF, cF)
    xp, hs, cs = x0_proj, [], []
    for l in range(len(cells)):
        if l > 0:
            xp = (matmul_at(outs, w_ih_up[l - 1], precision) + b_up[l - 1]).contiguous()
        outs, hF, cF = stack_fn(xp, mask, w_hh[l:l + 1], None, None, h0[l:l + 1], c0[l:l + 1],
                                precision)
        hs.append(hF[0])
        cs.append(cF[0])
    return outs, (torch.stack(hs), torch.stack(cs))


def lstm_stack_wavefront(cells: List[dict], x, mask, h0, c0,
                         stack_fn=lstm_stack_wavefront_fused, precision: str = HIGHEST):
    """Same contract and errors as
    ``empose_tpu/ops/lstm_kernel.py::lstm_stack_pallas_wavefront``: the
    results of :func:`lstm_stack`, the whole stack in one call of
    ``stack_fn``; ``ValueError`` below 2 layers or where the stack does not
    fit in one launch on the card (raised by ``stack_fn``: unlike
    :func:`lstm_stack`, the wavefront has no per-layer route)."""
    x0_proj, w_hh, w_ih_up, b_up = stack_operands(cells, x, precision)
    outs, hF, cF = stack_fn(x0_proj, mask.contiguous(), w_hh, w_ih_up, b_up,
                            h0.contiguous(), c0.contiguous(), precision)
    return outs, (hF, cF)


def lstm_bidi_plain(x_proj, mask, w_hh2, h0, c0, precision: str = HIGHEST):
    """The bidirectional kernel's function in plain torch, one direction after
    the other (see module doc)."""
    outs, hs, cs = [], [], []
    for d in range(2):
        o, hF, cF = lstm_cell_plain(x_proj[:, d], mask, w_hh2[d], h0[d], c0[d], precision)
        outs.append(o)
        hs.append(hF)
        cs.append(cF)
    return torch.stack(outs, dim=1), torch.stack(hs), torch.stack(cs)


class BidiPlan(NamedTuple):
    units: int       # hidden units per block (U): 8, or 4 where H % 8 == 4
    blocks: int      # the cooperative grid of one launch, dirs * H / U, one block per SM
    dirs: int        # directions per launch: 2 (both in one grid) or 1 (one launch each)
    launches: int    # launches per layer, 2 / dirs
    stage_rows: int  # rows of h[t-1] in shared memory: at highest N (all at once) or a ring
                     # of PASS_ROWS-row slots that the chunks cycle through; at high and
                     # default PASS_ROWS x stages
    stages: int      # the PASS_ROWS-row slots of those rows (N's chunks where all N rows
                     # fit); at high and default the ring of bf16 chunks that bulk copies
                     # fill
    smem_bytes: int  # dynamic shared memory per block


def bidi_smem_bytes(units: int, h: int, stage_rows: int, precision: str = HIGHEST) -> int:
    """Shared memory of one bidirectional-kernel block (``csrc/lstm_bidi.cu``):
    at highest (``smem_floats``) the resident fp32 gate columns of W_hh (to
    128 bytes) and the staged rows of h[t-1]; at high and default
    (``mma_smem_bytes``) the columns as bf16 B fragments (hi, and lo at
    high), a ring of ``stage_rows`` rows of h[t-1] in bf16 k-step tiles (16
    rows a slot; hi, and lo at high), the ring's mbarriers and the count of
    its chunks issued (RING_SYNC_BYTES) and two buffers of the partial
    tiles."""
    if resolve(precision) == HIGHEST:
        return 4 * (-(-4 * units * h // 32) * 32 + stage_rows * h)
    mat, partial = _mma_bytes(units, h, precision)
    return (mat + stage_rows * _bf16_parts(precision) * -(-h // 16) * 16 * 2 + RING_SYNC_BYTES
            + 2 * partial)


def bidi_exchange_shape(n: int, h: int, precision: str) -> Tuple[int, ...]:
    """The bidirectional kernel's bf16 exchange buffer at high and default:
    (slots 2, directions 2, parts (2 at high), 16-row chunks of N, k-steps of
    H padded to 16, a 16x16 tile)."""
    return (2, 2, _bf16_parts(precision), -(-n // PASS_ROWS), -(-h // 16), PASS_ROWS * 16)


@functools.lru_cache(maxsize=256)
def lstm_bidi_plan(n: int, h: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                   precision: str = HIGHEST) -> BidiPlan:
    """Launch plan of the bidirectional layer kernel for N rows at hidden
    size H.

    Each block owns U=8 units of one direction (U=4 where H % 8 == 4), one
    block per SM. Both directions run in one grid of 2H / U blocks where
    that fits on the SMs (H=512: 128 blocks); otherwise one direction per
    launch, H / U blocks each (H=1024: 128 blocks of 128 KB of columns). All
    N rows of h[t-1] are staged at once where they fit beside the block's
    columns (H=512: N <= 81); otherwise the PASS_ROWS-row chunks cycle
    through a ring of as many slots as fit (at most MAX_SLOTS; one at
    H=1024), so the shared memory stops growing with N and any N has a plan.
    Raises ValueError where H / U blocks do not fit on the SMs or not one
    slot fits beside the columns. At high and default the grid is the same,
    and the step's 16-row bf16 chunks stream through a ring of as many slots
    as fit beside the columns, up to MAX_SLOTS and the step's chunks (H=512:
    8 at default, 4 at high; H=1024: 4 and 1), ``stage_rows`` = PASS_ROWS x
    ``stages``."""
    if n <= 0 or h <= 0 or h % 4:
        raise ValueError(f"the bidirectional kernel needs N > 0 and H a positive multiple of "
                         f"4, got N={n}, H={h}")
    units = 8 if h % 8 == 0 else 4
    dirs = 2 if 2 * h // units <= sms else 1
    rows = n
    if resolve(precision) != HIGHEST:
        fixed = bidi_smem_bytes(units, h, 0, precision)
        slot = bidi_smem_bytes(units, h, PASS_ROWS, precision) - fixed
        rows = PASS_ROWS * min(MAX_SLOTS, -(-n // PASS_ROWS), max(0, smem_limit - fixed) // slot)
    elif bidi_smem_bytes(units, h, n) > smem_limit:
        rows = PASS_ROWS * min(MAX_SLOTS,
                               (smem_limit - bidi_smem_bytes(units, h, 0)) // (4 * PASS_ROWS * h))
    if h // units > sms or rows < 1:
        raise ValueError(f"the bidirectional kernel at N={n}, H={h} does not fit on {sms} SMs "
                         f"with {smem_limit} bytes of shared memory per block")
    return BidiPlan(units, dirs * h // units, dirs, 2 // dirs, rows, -(-rows // PASS_ROWS),
                    bidi_smem_bytes(units, h, rows, precision))


def lstm_bidi_prepare(device) -> None:
    """Once per device (the wrapper calls it at its first launch there):
    build the kernel if needed, set its shared memory and check its
    occupancy. Outside the per-call path, and outside any CUDA graph capture."""
    global _bidi_lib
    index = _device_index(device)
    if index in _bidi_prepared:
        return
    _bidi_lib = _bidi_library()
    info = (ctypes.c_int * 2)()
    cuda_build.check(_bidi_lib.lstm_bidi_prepare(index, info),
                     "bidirectional LSTM kernel setup")
    _bidi_prepared[index] = (info[0], info[1])


def lstm_bidi_fused(x_proj, mask, w_hh2, h0, c0, precision: str = HIGHEST):
    """One bidirectional layer at ``precision``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (see module doc for the
    contract). The launches follow :func:`lstm_bidi_plan`. The call does no
    setup after the first on a device and no synchronization, so it can be
    captured in a CUDA graph."""
    global BIDI_LAUNCHES
    if x_proj.device.type == "cpu":
        return lstm_bidi_plain(x_proj, mask, w_hh2, h0, c0, precision)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no bidirectional LSTM kernel for device {x_proj.device}")
    f, n, hidden = x_proj.shape[0], x_proj.shape[2], w_hh2.shape[1]
    dev = x_proj.device
    _check("x_proj", x_proj, (f, 2, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh2", w_hh2, (2, hidden, 4 * hidden), dev)
    _check("h0", h0, (2, n, hidden), dev)
    _check("c0", c0, (2, n, hidden), dev)
    index = x_proj.get_device()
    mode = resolve(precision)
    if mode == HIGHEST:
        plan = lstm_bidi_plan(n, hidden, *bidi_limits(dev))
        w_lo = None
    else:
        plan = lstm_bidi_plan(n, hidden, *bidi_limits(dev), mode)
        w_hh2, w_lo = kernel_weights(w_hh2, mode)
    # The kernel copies h0's rows 16 bytes at a time.
    h0 = h0 if h0.data_ptr() % 16 == 0 else h0.clone()
    outs = torch.empty(f, 2, n, hidden, device=dev)
    # The state apart from the outputs, so that a caller keeping only (hF, cF)
    # keeps no more: the h exchange buffer (2, 2) and cF (2), each plane on a
    # 16-byte boundary (H % 4 == 0); at high and default the bf16 exchange
    # buffer, which each launch fills itself.
    state = torch.empty(6, n, hidden, device=dev)
    xbuf = None if mode == HIGHEST else torch.empty(
        bidi_exchange_shape(n, hidden, mode), dtype=torch.bfloat16, device=dev)
    ptr = state.data_ptr()
    for d0 in range(0, 2, plan.dirs):
        code = _launch(_bidi_lib.lstm_bidi_forward, index, x_proj.data_ptr(), mask.data_ptr(),
                       w_hh2.data_ptr(), h0.data_ptr(), c0.data_ptr(), outs.data_ptr(), ptr,
                       ptr + 16 * n * hidden, f, n, hidden, plan.units, d0, plan.dirs,
                       plan.stage_rows, plan.smem_bytes, MODE_CODES[mode], _ptr(w_lo),
                       _ptr(xbuf))
        cuda_build.check(code, "bidirectional LSTM kernel")
        BIDI_LAUNCHES += 1
        _count("lstm_bidi", mode)
    h_last = 2 * (f & 1)  # h after the last step: hbuf[F & 1]
    return outs, state[h_last:h_last + 2], state[4:]


def lstm_bidi_layer(cell_fwd: dict, cell_bwd: dict, x_fwd, x_bwd, mask, h0, c0,
                    bidi_fn=lstm_bidi_fused, precision: str = HIGHEST):
    """Same contract as ``empose_tpu/ops/lstm_kernel.py::lstm_bidi_layer_pallas``:
    ``x_fwd`` (F, N, I) and ``x_bwd``, the same input reversed per sample by
    length; ``mask`` (F, N); ``h0``/``c0`` (2, N, H) [fwd, bwd] ->
    (outs (F, 2, N, H), the backward outputs in reversed time, (hF, cF)),
    every product at ``precision``."""
    xp_f = matmul_at(x_fwd, cell_fwd["w_ih"], precision) + cell_fwd["b_ih"] + cell_fwd["b_hh"]
    xp_b = matmul_at(x_bwd, cell_bwd["w_ih"], precision) + cell_bwd["b_ih"] + cell_bwd["b_hh"]
    x_proj = torch.stack([xp_f, xp_b], dim=1)
    w_hh2 = _stacked([cell_fwd["w_hh"], cell_bwd["w_hh"]], precision)
    outs, hF, cF = bidi_fn(x_proj, mask.contiguous(), w_hh2, h0.contiguous(), c0.contiguous(),
                           precision)
    return outs, (hF, cF)
