"""The bidirectional layer kernel's HIGH and DEFAULT body, on the CPU.

The kernel (``csrc/lstm_bidi.cu`` ``mma_body``) cannot run here, so this file
holds what surrounds it against what it must be:

* its launch plan at ``high`` and ``default`` (``lstm_bidi_plan``,
  ``bidi_smem_bytes``): the grid, the ring of 16-row bf16 chunks that bulk
  copies fill (as many slots as fit beside the resident B fragments, up to
  MAX_SLOTS and the step's chunks), the shared-memory formula, and the
  refusals;
* a numpy model of its exchange buffer: 16x16 k-step tiles whose rows'
  8-column halves are swizzled by row, each element written once by its
  owner, zeros past N and past H, read back as ``ldmatrix`` reads A
  fragments;
* the write-once data flow at both modes: the selected h[t] (h_new where
  the mask is 1, the old h where it is 0) rounded once into bf16 (hi, and lo
  at high) through that exchange, read by every block, then multiplied:
  bit for bit ``lstm_bidi_plain`` at the mode, with rows frozen by the mask
  and a 0-length row; and within its tolerance of the JAX reference (at
  HIGH ``_pallas_bidi`` in interpret mode, at DEFAULT a JAX scan with bf16
  products).

Inputs come from numpy seeds; each tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from empose_tpu.ops import lstm_kernel as JK

from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.ops import precision as P
from tests.torch_ring_model import (Exchange, count_needed, ends_clean, ring_run, ring_schedules,
                                     tile_offset)

torch.set_num_threads(1)

MODES = ("high", "default")
LIMIT = 232448  # the H100's opt-in shared memory per block (K.SMEM_LIMIT)


def _kp(h):
    return -(-h // 16) * 16


def _expected_plan(n, h, mode):
    """(units, stages, shared bytes) by the layout of ``mma_smem_bytes``: B
    fragments (parts x 8 U Kp bytes), the ring (16 rows x Kp bf16 a part a
    slot), the mbarriers and the count of chunks issued (144 bytes), two
    buffers of 8 warps' 16 x 4U f32 partial tiles."""
    parts = 2 if mode == "high" else 1
    units = 8 if h % 8 == 0 else 4
    fixed = parts * 8 * units * _kp(h) + 144 + 2 * 8 * 16 * 4 * units * 4
    slot = 16 * parts * _kp(h) * 2
    stages = min(K.MAX_SLOTS, -(-n // 16), (LIMIT - fixed) // slot)
    return units, stages, fixed + stages * slot


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, h", [(1, 512), (17, 512), (64, 512), (81, 512), (1300, 512),
                                  (1, 1024), (32, 1024), (1300, 1024), (7, 516), (300, 516),
                                  (7, 64), (17, 260)])
def test_bidi_mode_plan(mode, n, h):
    """The plan at the mode: HIGHEST's grid (U=8, U=4 where H % 8 == 4; both
    directions in one grid where 2H / U blocks fit, else one per launch), a
    ring of as many 16-row chunks as fit beside the fragments, up to
    MAX_SLOTS and the step's chunks, and the layout's bytes."""
    units, stages, smem = _expected_plan(n, h, mode)
    dirs = 2 if 2 * h // units <= K.SMS else 1
    plan = K.lstm_bidi_plan(n, h, precision=mode)
    assert plan == K.BidiPlan(units, dirs * h // units, dirs, 2 // dirs, 16 * stages, stages,
                              smem)
    assert plan.smem_bytes == K.bidi_smem_bytes(units, h, plan.stage_rows, mode) <= LIMIT
    assert 1 <= plan.stages <= K.MAX_SLOTS
    assert plan.launches == K.lstm_bidi_plan(n, h).launches  # HIGHEST's grid


def test_bidi_mode_plan_stages():
    """The ring's slots by shape: at H=512 DEFAULT a chunk is 16 KB beside
    32 KB of fragments, so every chunk of a step up to 8 is in flight (all
    four of N=64); HIGH's chunks and fragments are twice as large (4 slots);
    at H=1024 4 slots at DEFAULT and 1 at HIGH (128 KB of fragments)."""
    stages = lambda n, h, mode: K.lstm_bidi_plan(n, h, precision=mode).stages
    assert [stages(n, 512, "default") for n in (1, 17, 64, 81, 1300)] == [1, 2, 4, 6, 8]
    assert [stages(n, 512, "high") for n in (1, 17, 64, 81, 1300)] == [1, 2, 4, 4, 4]
    assert [stages(n, 1024, "default") for n in (1, 32, 1300)] == [1, 2, 4]
    assert [stages(n, 1024, "high") for n in (1, 32, 1300)] == [1, 1, 1]
    assert stages(300, 516, "default") == 8
    assert K.lstm_bidi_plan(32, 1024, precision="high").smem_bytes == 229520
    # HIGHEST keeps its own: all N rows at once where they fit.
    assert K.lstm_bidi_plan(64, 512) == K.BidiPlan(8, 128, 2, 1, 64, 4, 4 * (4 * 8 * 512
                                                                             + 64 * 512))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, h", [(0, 512), (4, 510), (4, 1028), (4, 4096)])
def test_bidi_mode_plan_refusals(mode, n, h):
    """No plan at the modes where HIGHEST has none (``test_bidi_launch_plan_refusals``)."""
    with pytest.raises(ValueError):
        K.lstm_bidi_plan(n, h, precision=mode)


def test_bidi_mode_plan_needs_one_slot():
    """H=1024 at HIGH takes 229,520 bytes with one slot: one byte less and
    no plan; at DEFAULT a smaller limit takes fewer slots."""
    K.lstm_bidi_plan(32, 1024, smem_limit=229520, precision="high")
    with pytest.raises(ValueError, match="does not fit"):
        K.lstm_bidi_plan(32, 1024, smem_limit=229519, precision="high")
    assert K.lstm_bidi_plan(64, 512, smem_limit=120000, precision="default").stages == 3


# ---------------------------------------------------------------------------
# A numpy model of the exchange buffer (tests/torch_ring_model.py)


def test_exchange_tile_layout():
    """A tile's offsets are a bijection of its 256 elements, each row's 16
    columns in its own 16 elements with the halves swapped in rows 4-7 and
    12-15; the eight 16-byte row reads of each of ldmatrix's four 8x8
    matrices fall in eight distinct 16-byte bank groups."""
    offs = np.array([[tile_offset(r, c) for c in range(16)] for r in range(16)])
    assert sorted(offs.ravel().tolist()) == list(range(256))
    for r in range(16):
        assert (offs[r] // 16 == r).all()
        for c in range(16):
            assert offs[r, c] % 16 // 8 == (c // 8) ^ (r // 4 % 2)
            assert offs[r, c] % 8 == c % 8
    for m in range(4):  # a0 rows 0-7 k 0-7, a1 rows 8-15, a2 and a3 k 8-15
        groups = [2 * tile_offset((m % 2) * 8 + i, (m // 2) * 8) % 128 // 16 for i in range(8)]
        assert sorted(groups) == list(range(8))


@pytest.mark.parametrize("n, h, units", [(17, 64, 8), (7, 36, 4), (33, 516, 4), (1, 48, 8)])
def test_exchange_round_trip(n, h, units):
    """Every element of the exchange is written exactly once per step (the
    owners' columns, the prologue's zeros), and the chunks read back are the
    state padded with zeros to 16-row chunks and Kp columns."""
    state = np.random.RandomState(n + h).randn(n, h).astype(np.float32)
    ex = Exchange(n, h, units)
    ex.write(state)
    assert (ex.writes == 1).all() and not np.isnan(ex.x).any()
    want = np.zeros((ex.chunks * 16, _kp(h)), np.float32)
    want[:n, :h] = state
    np.testing.assert_array_equal(ex.read(), want)
    assert ex.x.size * 2 * 2 * 2 == np.prod(K.bidi_exchange_shape(n, h, "high"))
    assert ex.x.size * 2 * 2 == np.prod(K.bidi_exchange_shape(n, h, "default"))


# ---------------------------------------------------------------------------
# The write-once data flow


F, N, H, UNITS = 10, 6, 36, 4  # H % 16 != 0: columns past H are padding


def _bidi_case(seed):
    """x_proj (F, 2, N, 4H), mask (rows of length F, 0, 7, F, 3, 1: a
    0-length row and rows frozen by the mask from step 7, 3 and 1), W_hh2,
    h0, c0, as numpy."""
    rng = np.random.RandomState(seed)
    lengths = np.array([F, 0, 7, F, 3, 1])
    mask = (np.arange(F)[:, None] < lengths[None]).astype(np.float32)
    x_proj = (rng.randn(F, 2, N, 4 * H) * 0.5).astype(np.float32)
    w_hh2 = ((rng.rand(2, H, 4 * H) * 2 - 1) * H ** -0.5).astype(np.float32)
    h0, c0 = (rng.randn(2, 2, N, H) * 0.5).astype(np.float32)
    return x_proj, mask, w_hh2, h0, c0


def _exchanged(h, mode):
    """The selected h's bf16 parts through the exchange: written once by the
    owners (split_bf16: hi, and lo at high), read back by every block."""
    out = []
    for part in P.bf16_parts(h, mode):
        ex = Exchange(N, H, UNITS)
        ex.write(part.float().numpy())
        out.append(torch.from_numpy(ex.read()[:N, :H]).to(torch.bfloat16))
    return out


def _write_once_flow(x_proj, mask, w_hh2, h0, c0, mode, steps=F):
    """One bidirectional layer with the data flow of the mode body: h0's and
    then each step's selected h rounded once through the exchange, the
    product of those parts with W_hh's (``hi@Wh`` at default; ``hi@Wh +
    lo@Wh + hi@Wl`` at high, dot3's order), the cell in f32."""
    outs, hs, cs = [], [], []
    for d in range(2):
        w = P.weight_parts(w_hh2[d], mode)
        h, c = h0[d], c0[d]
        a = _exchanged(h, mode)
        o = []
        for t in range(steps):
            prod = P.mm_bf16(a[0], w[0])
            if mode == "high":
                prod = prod + P.mm_bf16(a[1], w[0]) + P.mm_bf16(a[0], w[1])
            i, f, g, og = (x_proj[t, d] + prod).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(og) * torch.tanh(c_new)
            m = mask[t][:, None]
            h = torch.where(m > 0, h_new, h)
            c = torch.where(m > 0, c_new, c)
            o.append(h_new * m)
            a = _exchanged(h, mode)  # the selected h, not h_new
        outs.append(torch.stack(o))
        hs.append(h)
        cs.append(c)
    return torch.stack(outs, dim=1), torch.stack(hs), torch.stack(cs)


def _bf16_dot(a, w):
    return lax.dot_general(a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                           (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _jax_bidi_default(x_proj, mask, w_hh2, h0, c0):
    """``_make_bidi_kernel``'s recurrence as a JAX scan, its product with
    bf16 inputs and f32 sums: (outs, hF, cF)."""
    def direction(d):
        def step(carry, inp):
            hp, cp = carry
            xpt, m = inp
            gates = xpt + _bf16_dot(hp, w_hh2[d])
            i, f, g, o = jnp.split(gates, 4, axis=-1)
            c_new = lax.logistic(f) * cp + lax.logistic(i) * jnp.tanh(g)
            h_new = lax.logistic(o) * jnp.tanh(c_new)
            m1 = m[:, None]
            return ((jnp.where(m1 > 0, h_new, hp), jnp.where(m1 > 0, c_new, cp)), h_new * m1)
        (hF, cF), outs = lax.scan(step, (h0[d], c0[d]), (x_proj[:, d], mask))
        return outs, hF, cF
    (of, hf, cf), (ob, hb, cb) = direction(0), direction(1)
    return jnp.stack([of, ob], axis=1), jnp.stack([hf, hb]), jnp.stack([cf, cb])


# The JAX reference at the mode: at HIGH ``_pallas_bidi`` in interpret mode
# (dot3 of the same bf16 splits, f32 sums in another order; readings up to
# 2.2e-7 over seeds 0-7, the plain version at HIGHEST 1.1e-6 or more away),
# at DEFAULT the bf16 scan above (the same bf16 products; a 1-ulp difference
# in h can round an element of the next step's bf16 h the other way:
# readings up to 3.1e-6). About 2x and 6x the largest reading.
JAX_TOL = {"high": 5e-7, "default": 2e-5}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_plain_bidi_is_the_write_once_data_flow(mode, seed):
    """``lstm_bidi_plain`` (and the wrapper on CPU tensors) at the mode
    equals the write-once data flow bit for bit; rows frozen by the mask and
    the 0-length row keep their state bit for bit; the flow lies within
    JAX_TOL of the JAX reference at the mode, and at HIGH closer to it than
    the plain version at HIGHEST."""
    case = _bidi_case(seed)
    args = tuple(torch.from_numpy(a) for a in case)
    flow = _write_once_flow(*args, mode)
    for got in (K.lstm_bidi_plain(*args, mode), K.lstm_bidi_fused(*args, mode)):
        assert all(torch.equal(a, b) for a, b in zip(got, flow))
    x_proj, mask, w_hh2, h0, c0 = args
    assert torch.equal(flow[1][:, 1], h0[:, 1]) and torch.equal(flow[2][:, 1], c0[:, 1])
    assert (flow[0][:, :, 1] == 0).all()  # the 0-length row: zero outputs
    for row, length in ((2, 7), (4, 3), (5, 1)):  # frozen from their length on
        short = _write_once_flow(x_proj[:length], mask[:length], w_hh2, h0, c0, mode, length)
        assert torch.equal(flow[1][:, row], short[1][:, row])
        assert torch.equal(flow[2][:, row], short[2][:, row])
    if mode == "high":
        want = JK._pallas_bidi(*(jnp.asarray(a) for a in (case[0], case[1][:, :, None],
                                                           case[2], case[3], case[4])),
                               hidden=H, interpret=True, precision=lax.Precision.HIGH)
    else:
        want = _jax_bidi_default(*(jnp.asarray(a) for a in case))
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(flow, want))
    assert err <= JAX_TOL[mode], err
    if mode == "high":
        highest = K.lstm_bidi_plain(*args, "highest")
        gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for a, b in zip(highest, want))
        assert err < gap


# ---------------------------------------------------------------------------
# The ring's waits (tests/torch_ring_model.py, one item a chunk)


def test_bidi_ring_waits_for_the_issue():
    """The bidirectional layer's ring at the fault's order, three slots
    under four chunks with two teams and the copies landing newest first:
    without the wait for a chunk's issue a full mbarrier passes by parity a
    phase early (team 1 takes chunk 3 while chunk 0, before it in the slot,
    is in flight); with the wait every schedule here ends clean."""
    assert count_needed(4, 3)
    assert not ends_clean(1, 4, 3, 2, order="late", wait_issued=False)
    for order in ring_schedules(4) + [np.random.RandomState(s) for s in range(10, 15)]:
        assert ring_run(1, 4, 3, 2, order=order)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, h", [(96, 516), (81, 516), (1300, 516), (64, 512), (100, 512),
                                  (1300, 512), (32, 1024), (1300, 1024), (17, 260)])
def test_bidi_ring_runs_the_plans(mode, n, h):
    """The ring under the plan of each shape (two teams where a step has two
    chunks or more and the ring two slots, ``mma_body``'s rule; at H=516 and
    high from N=81 five slots under more chunks, a slot's chunks
    alternating between the teams, where the count is kept) ends under
    several schedules, every copy in its slot when it is read and never
    over a slot still being read."""
    plan = K.lstm_bidi_plan(n, h, precision=mode)
    chunks = -(-n // 16)
    teams = 2 if chunks > 1 and plan.stages > 1 else 1
    assert (teams == 2 and count_needed(chunks, plan.stages)) == (
        h == 516 and mode == "high" and n > 80)
    for order in ring_schedules(n + h):
        assert ring_run(1, chunks, plan.stages, teams, plan.units, order=order,
                        wait_issued=count_needed(chunks, plan.stages))
