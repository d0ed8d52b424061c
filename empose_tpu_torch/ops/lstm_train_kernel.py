"""The differentiable LSTM direction-layer: the CUDA training pair, its plain
versions, the autograd function that ties them together, and their counts.

The kernels (``csrc/lstm_train.cu``) replace the Pallas TPU kernels of
``empose_tpu/ops/lstm_train_kernel.py``: ``_pallas_fwd`` (the forward sweep
with W_hh resident, emitting the gate pre-activations and the carried h and
c of every step) and ``_pallas_bwd`` (the reverse-time sweep emitting dgates
and carrying dh, dc into dh0, dc0). The source file says what bounds them on
an H100 and how W_hh is spread over the SMs.

The decomposition is the JAX package's: only the serial recurrence runs in
the kernels; the input projection ``x @ W_ih + b_ih + b_hh``, ``outs =
h_all * mask``, the final states, ``dW_hh = h_prev^T @ dgates`` and
``dx_proj = dgates`` are plain torch around them.

Contracts (time-major, the JAX kernels' layouts; ``mask`` is (F, N), 1.0 at
valid steps):

* forward ``(x_proj (F, N, 4H), mask, w_hh (H, 4H), h0, c0 (N, H)) ->
  (gates (F, N, 4H) or None, h_all (F, N, H), c_all (F, N, H))``: ``h_all[t]``
  and ``c_all[t]`` are the carried state after step t, frozen (selected, not
  blended) where the mask is 0;
* backward ``(dh_all, dc_all (F, N, H), gates, c_prev (F, N, H), mask, w_hh)
  -> (dgates (F, N, 4H), dh0, dc0 (N, H))``: ``c_prev[t]`` is the cell state
  before step t; frozen steps give zero dgates and pass dh, dc through.

``lstm_train_fwd``/``lstm_train_bwd`` launch the kernels for CUDA tensors
and run the plain versions for CPU tensors; ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count kernel launches, and ``lstm_kernel.MODE_LAUNCHES``
counts them by precision under ``("lstm_train_fwd" | "lstm_train_bwd",
mode)``. Setup is out of the per-call path: :func:`lstm_train_prepare` sets
the kernels' shared memory and checks their occupancy once per device, and
the grids come from pure-Python plans (:func:`lstm_train_units`,
:func:`lstm_train_fwd_plan`, :func:`lstm_train_bwd_plan`), so a call can be
captured in a CUDA graph.

Every function here takes ``precision`` (``utils/precision.py``; default
``highest``), the mode of the JAX pair's ``precision`` argument: the step's
recurrent product (``h @ W_hh`` forward, ``dgates @ W_hh^T`` reverse) at
``highest`` in fp32, at ``default`` with bf16 inputs and f32 sums, at
``high`` as JAX's ``dot3`` against W_hh's bf16 hi/lo split; the kernels run
it on the tensor cores at ``high`` and ``default``. W_hh's bf16 form is made
outside the sweeps, as JAX splits it outside its kernels: :class:`LSTMCore`
makes it once per step and hands it to both (``w_parts``). The input
projection and the deferred ``dW_hh`` run at the same mode
(``ops/precision.py``); the gate nonlinearities, the cell and every saved
tensor stay f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from empose_tpu_torch.ops import cuda_build
# The geometry csrc/lstm_train.cu shares with the inference kernels (threads
# per block, rows of a staged chunk and pass in the forward sweep, the
# forward sweep's most ring slots, the warps of a tensor-core product) and
# the H100 SXM's SMs and opt-in shared memory per block.
from empose_tpu_torch.ops.lstm_kernel import (MAX_SLOTS, MMA_WARPS, PASS_ROWS, RING_SYNC_BYTES,
                                              SMEM_LIMIT, SMS, THREADS, _bf16_parts, _check,
                                              _count, _launch, _mma_bytes, _ptr,
                                              _sigmoid_tanh_cell, units_per_block)
from empose_tpu_torch.ops.precision import (MODE_CODES, bf16_parts, matmul_at, product_at,
                                            weight_parts)
from empose_tpu_torch.utils.precision import HIGHEST, resolve

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

NAME = "lstm_train"  # csrc/lstm_train.cu

TILE_ROWS = 4  # rows of a thread's register tile in the reverse sweep

_prepared: Dict[int, Tuple[int, int]] = {}  # device index -> (SMs, opt-in shared bytes)
_lib = None  # the kernels' library, once lstm_train_prepare has loaded it


class FwdPlan(NamedTuple):
    units: int       # hidden units per block (U)
    blocks: int      # the cooperative grid, H / U
    stage_rows: int  # rows of h_all[t-1] in shared memory: at highest N (all at once), or
                     # fewer: a ring of stage_rows / PASS_ROWS slots that the PASS_ROWS-row
                     # chunks cycle through; at high and default PASS_ROWS x the slots of the
                     # ring of bf16 chunks that bulk copies fill
    teams: int       # read at high and default only (highest: 1): teams of 4 warps in a
                     # block of 8, 2 where a step has two chunks or more and the ring two
                     # slots or more, else 1 of 8 warps
    smem_bytes: int  # dynamic shared memory per block


class BwdPlan(NamedTuple):
    units: int       # hidden units per block (U)
    blocks: int      # the cooperative grid, H / U
    row_groups: int  # thread row groups of a pass (THREADS / row_groups k-splits each)
    rows_per_pass: int  # rows a pass multiplies (at most TILE_ROWS per group)
    stage_rows: int  # rows of dgates[t] per staged chunk
    stages: int      # highest: 1, all N rows staged at once, or 2, a ring of two row
                     # chunks; high and default: the ring's stages (2 to MAX_SLOTS), each
                     # a 16-row k-slice of k_cols columns
    resident: bool   # step operands and carries in shared memory (else in device memory)
    k_cols: int      # columns of dgates[t] staged at once: 4H at highest; at high and
                     # default the k-slice of a 16-row bf16 stage (one row group)
    smem_bytes: int  # dynamic shared memory per block


def lstm_train_units(h: int, sms: int = SMS, precision: str = HIGHEST) -> int:
    """Hidden units per block for hidden size H: the smallest power of two
    (at most 8) that divides H and gives at most one block per SM; at high
    and default at least 2 (an n8 tile of the tensor-core product holds two
    units' four gates)."""
    units = units_per_block(h, sms)
    if not units:
        raise ValueError(f"no units-per-block choice puts H={h} on {sms} SMs")
    return units if resolve(precision) == HIGHEST else max(units, 2)


def fwd_smem_bytes(units: int, h: int, stage_rows: int, precision: str = HIGHEST,
                   teams: int = 1) -> int:
    """Shared memory of one forward-sweep block (``csrc/lstm_train.cu``
    ``lstm_train_fwd_smem_bytes``): at highest (``fwd_smem_floats``) the
    resident gate columns of W_hh (to 128 bytes) and the staged rows of
    h_all[t-1]; at high and default (``fwd_mma_smem_bytes``) the columns as
    bf16 B fragments (hi, and lo at high), a ring of ``stage_rows`` rows of
    h_all[t-1] in bf16 k-step tiles (16 rows a slot; hi, and lo at high),
    the ring's mbarriers and the count of its chunks issued
    (RING_SYNC_BYTES) and a buffer of the partial tiles for each of
    ``teams`` teams."""
    if resolve(precision) == HIGHEST:
        return 4 * (-(-4 * units * h // 32) * 32 + stage_rows * h)
    mat, partial = _mma_bytes(units, h, precision)
    return (mat + stage_rows * _bf16_parts(precision) * -(-h // 16) * 16 * 2 + RING_SYNC_BYTES
            + teams * partial)


def fwd_exchange_shape(n: int, h: int, precision: str) -> Tuple[int, ...]:
    """The forward sweep's bf16 exchange buffer at high and default: (slots
    2, parts (2 at high), 16-row chunks of N, k-steps of H padded to 16, a
    16x16 tile)."""
    return (2, _bf16_parts(precision), -(-n // PASS_ROWS), -(-h // 16), PASS_ROWS * 16)


@functools.lru_cache(maxsize=256)
def lstm_train_fwd_plan(n: int, h: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                        precision: str = HIGHEST) -> FwdPlan:
    """Launch plan of the forward sweep for N rows at hidden size H.

    All N rows of h_all[t-1] are staged at once where they fit beside the
    block's columns of W_hh (at H=512: N <= 97). Otherwise the chunks of
    PASS_ROWS rows cycle through a ring of as many slots as fit (at most
    MAX_SLOTS; one at H=1024), so the shared memory stops growing with N and
    any N has a plan. Raises ValueError only where not one slot fits. At
    high and default the grid is the same (U >= 2), and the step's 16-row
    bf16 chunks stream through a ring of slots: where a step has two chunks
    or more and two slots fit beside the columns and two buffers of partial
    tiles, two teams of 4 warps take the chunks in turns through as many
    slots as fit there, up to MAX_SLOTS and the step's chunks (H=512: 8 at
    default, 5 at high; H=1024 at default: 4); else one team of 8 warps and
    one slot (H=1024 at high), ``stage_rows`` = PASS_ROWS x the slots."""
    if n <= 0 or h <= 0 or h % 4:
        raise ValueError(f"the forward sweep needs N > 0 and H a positive multiple of 4, got "
                         f"N={n}, H={h}")
    units = lstm_train_units(h, sms, precision)
    if resolve(precision) != HIGHEST:
        bytes_of = functools.partial(fwd_smem_bytes, units, h, precision=precision)
        slot = bytes_of(PASS_ROWS) - bytes_of(0)
        chunks = -(-n // PASS_ROWS)
        teams, stages = 2, min(MAX_SLOTS, chunks, max(0, smem_limit - bytes_of(0, teams=2)) // slot)
        if stages < 2:
            teams, stages = 1, min(1, max(0, smem_limit - bytes_of(0)) // slot)
        if stages < 1:
            raise ValueError(f"the forward sweep at N={n}, H={h}, precision {precision} does "
                             f"not fit in {smem_limit} bytes of shared memory")
        rows = PASS_ROWS * stages
        return FwdPlan(units, h // units, rows, teams, bytes_of(rows, teams=teams))
    rows = n
    if fwd_smem_bytes(units, h, n) > smem_limit:
        slots = min(MAX_SLOTS, (smem_limit - fwd_smem_bytes(units, h, 0)) // (4 * PASS_ROWS * h))
        if slots < 1:
            raise ValueError(f"the forward sweep at N={n}, H={h} does not fit in {smem_limit} "
                             "bytes of shared memory")
        rows = PASS_ROWS * slots
    return FwdPlan(units, h // units, rows, 1, fwd_smem_bytes(units, h, rows))


def bwd_operand_bytes(units: int, n: int) -> int:
    """Shared memory of the reverse sweep's resident step operands (dh_all,
    dc_all, c_prev, four gate columns per unit, and the mask, each to 16
    bytes) and carries dh and dc."""
    r4 = lambda x: -(-x // 4) * 4
    return 4 * (r4(7 * units * n) + r4(n) + 2 * units * n)


def bwd_smem_bytes(units: int, n: int, h: int, stages: int, stage_rows: int,
                   resident: bool = True) -> int:
    """Shared memory of one reverse-sweep block (``csrc/lstm_train.cu``
    ``bwd_smem_floats``): the resident rows of W_hh (to 128 bytes), the
    stages of dgates[t], where ``resident`` the next step's operands and
    the carries (:func:`bwd_operand_bytes`), and the warps' partial sums."""
    rows = bwd_operand_bytes(units, n) if resident else 0
    return 4 * (-(-units * 4 * h // 32) * 32 + stages * stage_rows * 4 * h
                + THREADS // 32 * TILE_ROWS * units) + rows


def bwd_mma_smem_bytes(units: int, n: int, h: int, k_cols: int, stages: int, resident: bool,
                       precision: str) -> int:
    """Shared memory of one reverse-sweep block at high or default
    (``csrc/lstm_train.cu`` ``bwd_mma_smem_bytes``): the block's rows of
    W_hh as the B fragments of one n8 tile per k-step of 4H (hi, and lo at
    high); a ring of ``stages`` stages, each a 16-row k-slice of dgates[t]
    of ``k_cols`` columns in bf16 k-step tiles (hi, and lo at high); the
    ring's mbarriers (128 bytes); two buffers of the partial tiles of one
    n8 tile; where ``resident``, the step operands and carries
    (:func:`bwd_operand_bytes`)."""
    parts = _bf16_parts(precision)
    return (parts * (h // 4) * 32 * 8 + stages * parts * PASS_ROWS * k_cols * 2 + 128
            + 2 * MMA_WARPS * PASS_ROWS * 8 * 4 + (bwd_operand_bytes(units, n) if resident else 0))


@functools.lru_cache(maxsize=256)
def lstm_train_bwd_plan(n: int, h: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                        precision: str = HIGHEST) -> BwdPlan:
    """Launch plan of the reverse sweep for N rows at hidden size H.

    Row groups: 1, 2 or 4, the fewest whose register tiles (TILE_ROWS rows a
    group) cover min(N, 16) rows, so a pass is sized to N. All N rows of
    dgates[t] are staged at once where they fit beside the rest of the
    block's shared memory; else a ring of two stages of up to 16 rows each,
    so that a pass still spans up to four row groups (on an H100, passes of
    16 rows were faster than more, smaller passes with a deeper ring). The
    step operands and carries go into shared memory (``resident``) unless
    the ring then needs more chunks per step than without them (at H=512:
    N = 24, 100 and any N above 121, among others); else they stay in
    device memory, and the shared memory does not grow with N. Raises
    ValueError only where not one row of dgates fits in each of two
    stages.

    At high and default the grid is the same (U >= 2). The step's bf16
    dgates[t] streams through a ring of stages, each a 16-row chunk's
    k-slice of ``k_cols`` columns: 4H in the fewest slices, each a multiple
    of 128 columns (or all 4H), of which two stages fit beside the block's
    fragments of W_hh (H=512: 2048 at default, 1024 at high; H=1024: 2048,
    640): a step has the fewest stages, each of which costs a wait, and
    every slice starts at a multiple of MMA_WARPS k-steps, so the sums do
    not depend on the slicing. The ring takes as many stages as fit, up to
    MAX_SLOTS and the step's stages (at least 2). The step operands and
    carries go into shared memory (``resident``) where they fit beside that
    ring, else they stay in device memory, so any N runs."""
    if n <= 0 or h <= 0 or h % 4:
        raise ValueError(f"the reverse sweep needs N > 0 and H a positive multiple of 4, got "
                         f"N={n}, H={h}")
    units = lstm_train_units(h, sms, precision)
    if resolve(precision) != HIGHEST:
        smem = functools.partial(bwd_mma_smem_bytes, units, n, h, precision=precision)
        k_cols = next((k for k in (min(4 * h, 128 * -(-4 * h // (128 * s)))
                                   for s in range(1, h // 32 + 2))
                       if smem(k, 2, False) <= smem_limit), 0)
        if not k_cols:
            raise ValueError(f"the reverse sweep at N={n}, H={h}, precision {precision} does "
                             f"not fit in {smem_limit} bytes of shared memory")
        per_step = -(-n // PASS_ROWS) * -(-4 * h // k_cols)
        stage = smem(k_cols, 1, False) - smem(k_cols, 0, False)
        stages = max(2, min(MAX_SLOTS, per_step, (smem_limit - smem(k_cols, 0, False)) // stage))
        resident = smem(k_cols, stages, True) <= smem_limit
        return BwdPlan(units, h // units, 1, PASS_ROWS, PASS_ROWS, stages, resident, k_cols,
                       smem(k_cols, stages, resident))
    if bwd_smem_bytes(units, n, h, 1, n) <= smem_limit:
        stages, rows, resident = 1, n, True
    else:
        stages = 2
        ring = {r: min(4 * TILE_ROWS, n, (smem_limit - bwd_smem_bytes(units, n, h, 0, 0, r))
                       // (2 * 4 * 4 * h)) for r in (True, False)}
        resident = ring[True] >= 1 and -(-n // ring[True]) <= -(-n // ring[False])
        rows = ring[resident]
        if rows < 1:
            raise ValueError(f"the reverse sweep at N={n}, H={h} does not fit in {smem_limit} "
                             "bytes of shared memory")
    groups = next(g for g in (1, 2, 4) if TILE_ROWS * g >= min(rows, 4 * TILE_ROWS))
    return BwdPlan(units, h // units, groups, min(TILE_ROWS * groups, rows), rows, stages,
                   resident, 4 * h, bwd_smem_bytes(units, n, h, stages, rows, resident))


def _library():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(NAME, {
        "lstm_train_prepare": ([i, ctypes.POINTER(i)], i),
        "lstm_train_forward": ([p] * 8 + [i] * 8 + [p, p, p], i),
        "lstm_train_fwd_smem_bytes": ([i] * 5, ctypes.c_longlong),
        "lstm_train_backward": ([p] * 9 + [i] * 11 + [p, p, p], i),
    })


def lstm_train_prepare(device) -> None:
    """Once per device (the wrappers call it at their first launch there):
    build the kernels if needed, set their shared memory and check their
    occupancy. Outside the per-call path, and outside any CUDA graph capture."""
    global _lib
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index in _prepared:
        return
    _lib = _library()
    info = (ctypes.c_int * 2)()
    cuda_build.check(_lib.lstm_train_prepare(index, info), "LSTM training kernel setup")
    _prepared[index] = (info[0], info[1])


def _weight_form(w_hh, mode: str, w_parts) -> Tuple[torch.Tensor, ...]:
    """W_hh as the step's product takes it at ``mode``: ``(w_hh,)`` at
    highest, else its bf16 parts, ``w_parts`` where the caller made them
    (:class:`LSTMCore`, once for both sweeps), else ``weight_parts``."""
    if mode == HIGHEST:
        return (w_hh,)
    return weight_parts(w_hh, mode) if w_parts is None else tuple(w_parts)


def _recurrent(a: torch.Tensor, form: Tuple[torch.Tensor, ...], mode: str) -> torch.Tensor:
    """``a @ W`` at ``mode``, W given by its form (``_weight_form``)."""
    return a @ form[0] if mode == HIGHEST else product_at(a, form, mode)


def lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, save_gates: bool = True,
                         precision: str = HIGHEST, w_parts=None):
    """The forward sweep step by step in plain torch (see module doc), the
    recurrent product at ``precision``."""
    mode = resolve(precision)
    form = _weight_form(w_hh, mode, w_parts)
    h, c = h0, c0
    gates_all, hs, cs = [], [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t] + _recurrent(h, form, mode)
        h_new, c_new = _sigmoid_tanh_cell(gates, c)
        m = mask[t][:, None]
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        gates_all.append(gates)
        hs.append(h)
        cs.append(c)
    return (torch.stack(gates_all) if save_gates else None), torch.stack(hs), torch.stack(cs)


def lstm_train_bwd_plain(dh_all, dc_all, gates, c_prev, mask, w_hh, precision: str = HIGHEST,
                         w_parts=None):
    """The reverse sweep step by step in plain torch, the formulas of
    ``empose_tpu/ops/lstm_train_kernel.py::_make_bwd_kernel`` (see module
    doc), the product with W_hh^T at ``precision``."""
    mode = resolve(precision)
    form_t = tuple(w.t() for w in _weight_form(w_hh, mode, w_parts))
    dh = torch.zeros_like(dh_all[0])
    dc = torch.zeros_like(dc_all[0])
    dgates = torch.empty_like(gates)
    for t in range(gates.shape[0] - 1, -1, -1):
        m = mask[t][:, None]
        Dh = dh + dh_all[t]
        Dc = dc + dc_all[t]
        gi, gf, gg, go = gates[t].chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        cp = c_prev[t]
        tc = torch.tanh(f * cp + i * g)
        dh_new = Dh * m
        dc_new = Dc * m + dh_new * o * (1.0 - tc * tc)
        dgates[t] = torch.cat([dc_new * g * i * (1.0 - i), dc_new * cp * f * (1.0 - f),
                               dc_new * i * (1.0 - g * g), dh_new * tc * o * (1.0 - o)], dim=-1)
        dh = _recurrent(dgates[t], form_t, mode) + Dh * (1.0 - m)
        dc = dc_new * f + Dc * (1.0 - m)
    return dgates, dh, dc


def _kernel_weight(w_hh, mode: str, w_parts, dev, hidden: int):
    """(w, w_lo) as the C entries take W_hh at ``mode``: the f32 block and
    None at highest; its bf16 (hi, lo) at high, (bf16, None) at default."""
    form = _weight_form(w_hh, mode, w_parts)
    if mode != HIGHEST and any(
            p.device != dev or p.dtype != torch.bfloat16 or p.shape != (hidden, 4 * hidden)
            or not p.is_contiguous() for p in form):
        raise ValueError(f"W_hh's bf16 form must be contiguous bf16 ({hidden}, {4 * hidden}) "
                         f"on {dev}")
    return form[0], form[1] if len(form) > 1 else None


def lstm_train_fwd(x_proj, mask, w_hh, h0, c0, save_gates: bool = True,
                   precision: str = HIGHEST, w_parts=None):
    """The forward sweep at ``precision``: the kernel for CUDA tensors, the
    plain version for CPU tensors. ``w_parts``: W_hh's bf16 form at high
    or default where the caller made it (else made here, once per weight)."""
    global FWD_LAUNCHES
    if x_proj.device.type == "cpu":
        return lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, save_gates, precision, w_parts)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no LSTM training kernel for device {x_proj.device}")
    f, n, _ = x_proj.shape
    hidden = w_hh.shape[0]
    dev = x_proj.device
    _check("x_proj", x_proj, (f, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh", w_hh, (hidden, 4 * hidden), dev)
    _check("h0", h0, (n, hidden), dev)
    _check("c0", c0, (n, hidden), dev)
    mode = resolve(precision)
    index = x_proj.get_device()
    if index not in _prepared:
        lstm_train_prepare(dev)
    plan = lstm_train_fwd_plan(n, hidden, *_prepared[index], mode)
    w, w_lo = _kernel_weight(w_hh, mode, w_parts, dev, hidden)
    # The kernel copies x_proj's gate columns and h0's rows 16 bytes at a time.
    x_proj, h0 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x_proj, h0))
    gates = torch.empty(f, n, 4 * hidden, device=dev) if save_gates else None
    h_all = torch.empty(f, n, hidden, device=dev)
    c_all = torch.empty(f, n, hidden, device=dev)
    # At high and default the kernel's bf16 exchange buffer: two slots of
    # h_all[t]'s bf16 parts in k-step tiles, written by their owners and read
    # by every block; the launch sets all of it (no zeroing here).
    xbuf = None if mode == HIGHEST else torch.empty(
        fwd_exchange_shape(n, hidden, mode), dtype=torch.bfloat16, device=dev)
    code = _launch(_lib.lstm_train_forward, index, x_proj.data_ptr(), mask.data_ptr(),
                   w.data_ptr(), h0.data_ptr(), c0.data_ptr(), _ptr(gates), h_all.data_ptr(),
                   c_all.data_ptr(), f, n, hidden, plan.units, plan.stage_rows, plan.smem_bytes,
                   MODE_CODES[mode], plan.teams, _ptr(w_lo), _ptr(xbuf))
    cuda_build.check(code, "LSTM training forward kernel")
    FWD_LAUNCHES += 1
    _count("lstm_train_fwd", mode)
    return gates, h_all, c_all


def lstm_train_bwd(dh_all, dc_all, gates, c_prev, mask, w_hh, precision: str = HIGHEST,
                   w_parts=None):
    """The reverse sweep at ``precision``: the kernel for CUDA tensors, the
    plain version for CPU tensors (``w_parts`` as for :func:`lstm_train_fwd`)."""
    global BWD_LAUNCHES
    if gates.device.type == "cpu":
        return lstm_train_bwd_plain(dh_all, dc_all, gates, c_prev, mask, w_hh, precision,
                                    w_parts)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM training kernel for device {gates.device}")
    f, n, _ = gates.shape
    hidden = w_hh.shape[0]
    dev = gates.device
    for name, t in (("dh_all", dh_all), ("dc_all", dc_all), ("c_prev", c_prev)):
        _check(name, t, (f, n, hidden), dev)
    _check("gates", gates, (f, n, 4 * hidden), dev)
    _check("mask", mask, (f, n), dev)
    _check("w_hh", w_hh, (hidden, 4 * hidden), dev)
    mode = resolve(precision)
    index = gates.get_device()
    if index not in _prepared:
        lstm_train_prepare(dev)
    sms, max_smem = _prepared[index]
    plan = lstm_train_bwd_plan(n, hidden, sms, max_smem, mode)
    w, w_lo = _kernel_weight(w_hh, mode, w_parts, dev, hidden)
    dgates = torch.empty_like(gates)
    dh0 = torch.empty(n, hidden, device=dev)
    dc0 = torch.empty(n, hidden, device=dev)
    # At high and default the kernel's bf16 exchange buffer: two slots of
    # dgates[t]'s bf16 parts (its rows to 16), written by their owners and
    # read by every block.
    xbuf = None if mode == HIGHEST else torch.empty(
        2, _bf16_parts(mode), -(-n // PASS_ROWS) * PASS_ROWS, 4 * hidden, dtype=torch.bfloat16,
        device=dev)
    code = _launch(_lib.lstm_train_backward, index, dh_all.data_ptr(), dc_all.data_ptr(),
                   gates.data_ptr(), c_prev.data_ptr(), mask.data_ptr(), w.data_ptr(),
                   dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), f, n, hidden, plan.units,
                   plan.row_groups, plan.stage_rows, plan.stages, int(plan.resident),
                   plan.k_cols, plan.smem_bytes, MODE_CODES[mode], _ptr(w_lo), _ptr(xbuf))
    cuda_build.check(code, "LSTM training backward kernel")
    BWD_LAUNCHES += 1
    _count("lstm_train_bwd", mode)
    return dgates, dh0, dc0


class LSTMCore(torch.autograd.Function):
    """``(x_proj, mask, w_hh, h0, c0) -> (h_all, c_all)`` through a forward and
    a backward sweep at ``mode`` (``_lstm_core`` with its custom VJP in the
    JAX package).

    At high and default W_hh's bf16 form is made once in the forward and
    saved for the backward (``ops/precision.derived`` keeps nothing for a
    weight autograd tracks). Saves ``gates``, ``h_prev`` and ``c_prev`` (the
    state before every step); the backward returns ``dx_proj = dgates``,
    ``dW_hh = h_prev^T @ dgates`` (at ``mode``: both operands are
    activations, rounded or split here), ``dh0`` and ``dc0``, and none for
    the mask."""

    @staticmethod
    def forward(ctx, x_proj, mask, w_hh, h0, c0, fwd, bwd, mode=HIGHEST):
        parts = () if mode == HIGHEST else bf16_parts(w_hh, mode)
        gates, h_all, c_all = fwd(x_proj, mask, w_hh, h0, c0, True, mode, parts or None)
        h_prev = torch.cat([h0[None], h_all[:-1]])
        c_prev = torch.cat([c0[None], c_all[:-1]])
        ctx.save_for_backward(gates, h_prev, c_prev, mask, w_hh, *parts)
        ctx.bwd, ctx.mode = bwd, mode
        return h_all, c_all

    @staticmethod
    def backward(ctx, dh_all: Optional[torch.Tensor], dc_all: Optional[torch.Tensor]):
        gates, h_prev, c_prev, mask, w_hh, *parts = ctx.saved_tensors
        zeros = torch.zeros_like(c_prev)
        dh_all = zeros if dh_all is None else dh_all.contiguous()
        dc_all = zeros if dc_all is None else dc_all.contiguous()
        dgates, dh0, dc0 = ctx.bwd(dh_all, dc_all, gates, c_prev, mask, w_hh, ctx.mode,
                                   tuple(parts) or None)
        hidden = w_hh.shape[0]
        h2, g2 = h_prev.reshape(-1, hidden).t(), dgates.reshape(-1, 4 * hidden)
        dw_hh = h2 @ g2 if ctx.mode == HIGHEST else product_at(h2, bf16_parts(g2, ctx.mode),
                                                                 ctx.mode)
        return dgates, None, dw_hh, dh0, dc0, None, None, None


def lstm_cell_train(cell: dict, x: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor, fwd=lstm_train_fwd, bwd=lstm_train_bwd,
                    precision: str = HIGHEST):
    """Differentiable drop-in for ``empose_tpu/ops/lstm_train_kernel.py::
    lstm_cell_train_pallas``: one LSTM direction-layer over time, state frozen
    at masked steps; gradients flow to the cell's weights, ``x``, ``h0`` and
    ``c0``. ``fwd``/``bwd`` are the sweeps (a reference run on the card may
    pass the plain versions); every product runs at ``precision`` (the
    input projection through ``matmul_at``).

    :param cell: w_ih (I, 4H), w_hh (H, 4H), b_ih, b_hh (4H,).
    :param x: (F, N, I); :param mask: (F, N).
    :return: (outputs (F, N, H) zeroed at masked steps, (hF, cF)).
    """
    mode = resolve(precision)
    x_proj = (matmul_at(x, cell["w_ih"], mode) + cell["b_ih"] + cell["b_hh"]).contiguous()
    w_hh = cell["w_hh"].contiguous()
    mask = mask.contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, w_hh, h0, c0)):
        h_all, c_all = LSTMCore.apply(x_proj, mask, w_hh, h0, c0, fwd, bwd, mode)
    else:
        # The undifferentiated primal: no gate pre-activations are kept.
        _, h_all, c_all = fwd(x_proj, mask, w_hh, h0, c0, False, mode)
    outs = h_all * mask[:, :, None]
    return outs, (h_all[-1], c_all[-1])
