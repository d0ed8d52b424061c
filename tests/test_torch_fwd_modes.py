"""The LSTM training forward sweep's HIGH and DEFAULT body, on the CPU.

The kernel (``csrc/lstm_train.cu`` ``fwd_mma``, ``fwd_steps``) cannot run
here, so this file holds what surrounds it against what it must be:

* its launch plan at ``high`` and ``default`` (``lstm_train_fwd_plan``,
  ``fwd_smem_bytes``): the ring of 16-row bf16 chunks that bulk copies fill
  (two teams of 4 warps on as many slots as fit beside the resident B
  fragments and two buffers of partial tiles, up to MAX_SLOTS and the
  step's chunks, where a step has two chunks or more; else one team, one
  slot, one buffer), the shared-memory formula, and the refusals;
* the exchange of h_all[t]'s bf16 hi and lo parts through 16x16 k-step
  tiles (``tests/torch_ring_model.py``), each element written once by its
  owner, zeros past N and past H, read back as ``ldmatrix`` reads A
  fragments (``fwd_exchange_shape``);
* the ring's copies and waits at one item a chunk, one actor a warp,
  copies landing in any order: every plan and every slot count ends clean
  with the wait for a chunk's issue where the kernel keeps the count (two
  teams on an odd slot count under the step's chunks), and without it the
  model finds a full mbarrier passed by parity a phase early there; on any
  other ring no wait is needed;
* the write-once data flow at both modes: h0 and then each step's
  selected h (h_new where the mask is 1, the old h where it is 0) rounded
  once into bf16 through that exchange, read back by every block, then
  multiplied: bit for bit ``lstm_train_fwd_plain`` at the mode (and the
  wrapper on CPU tensors), with 0-length, partial and full rows; within
  ``FWD_HIGH_TOL`` of the JAX ``_pallas_fwd`` in interpret mode at HIGH,
  and at DEFAULT within ``DEFAULT_EMUL_TOL`` of a JAX scan with bf16
  products and ``BF16_TOL`` of ``_pallas_fwd`` in interpret mode (whose
  DEFAULT dot runs in f32 on the CPU): the tolerances of
  ``tests/test_torch_train_precision.py``.

Inputs come from numpy seeds; each tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from empose_tpu.ops import lstm_kernel as JK
from empose_tpu.ops import lstm_train_kernel as JT

from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.ops import precision as P
from tests.test_torch_train_precision import BF16_TOL, DEFAULT_EMUL_TOL, FWD_HIGH_TOL
from tests.torch_ring_model import (Exchange, count_needed, ends_clean, kp16, ring_run,
                                     ring_schedules)

torch.set_num_threads(1)

MODES = ("high", "default")
LIMIT = 232448  # the H100's opt-in shared memory per block (SMEM_LIMIT)
UNITS = {20: 2, 512: 4, 1024: 8}  # HIGHEST's grid, at least 2 units a block


def _expected_plan(n, h, mode, limit=LIMIT):
    """(units, stages, teams, shared bytes) by the layout of
    ``fwd_mma_smem_bytes``: B fragments (parts x 8 U Kp bytes), the ring
    (16 rows x Kp bf16 a part a slot), the mbarriers and the count of the
    chunks issued (144 bytes), a buffer of 8 warps' 16 x 4U f32 partial
    tiles for each team."""
    parts = 2 if mode == "high" else 1
    units = UNITS[h]
    fixed = parts * 8 * units * kp16(h) + 144
    partial = 8 * 16 * 4 * units * 4
    slot = 16 * parts * kp16(h) * 2
    chunks = -(-n // 16)
    stages = min(8, chunks, (limit - fixed - 2 * partial) // slot)
    teams = 2 if stages >= 2 else 1
    if teams == 1:
        stages = min(1, (limit - fixed - partial) // slot)
    return units, stages, teams, fixed + teams * partial + stages * slot


PLAN_SHAPES = [(n, h) for h in (20, 512, 1024) for n in (1, 16, 17, 64, 100, 1300)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, h", PLAN_SHAPES)
def test_fwd_mode_plan(mode, n, h):
    """The plan at the mode: HIGHEST's grid (U >= 2), the ring's slots and
    teams, the layout's bytes; two teams only where a step has two chunks or
    more and the ring two slots or more."""
    units, stages, teams, smem = _expected_plan(n, h, mode)
    plan = TK.lstm_train_fwd_plan(n, h, precision=mode)
    assert plan == TK.FwdPlan(units, h // units, 16 * stages, teams, smem)
    assert plan.smem_bytes == TK.fwd_smem_bytes(units, h, plan.stage_rows, mode, teams) <= LIMIT
    assert 1 <= stages <= TK.MAX_SLOTS and stages <= -(-n // 16)
    assert (teams == 2) == (-(-n // 16) >= 2 and stages >= 2)
    highest = TK.lstm_train_fwd_plan(n, h)
    assert highest.teams == 1 and highest.blocks == plan.blocks * plan.units // highest.units


def test_fwd_mode_plan_slots_and_teams():
    """The ring by shape: at H=512 DEFAULT a slot is 16 KB beside 16 KB of
    fragments, so every chunk of a step up to 8 is in flight (4 at N=64, 7
    at N=100); HIGH's slots and fragments are twice as large: 5 slots, the
    odd count under N=100's seven chunks; at H=1024 4 slots at DEFAULT and
    at HIGH one team on one slot (128 KB of fragments); N <= 16 one chunk,
    one team."""
    plan = lambda n, h, mode: TK.lstm_train_fwd_plan(n, h, precision=mode)
    shape = lambda *a: (plan(*a).stage_rows // 16, plan(*a).teams)
    assert [shape(n, 512, "default") for n in (16, 17, 64, 100, 1300)] == \
        [(1, 1), (2, 2), (4, 2), (7, 2), (8, 2)]
    assert [shape(n, 512, "high") for n in (16, 17, 64, 100, 1300)] == \
        [(1, 1), (2, 2), (4, 2), (5, 2), (5, 2)]
    assert [shape(n, 1024, "default") for n in (16, 32, 64, 1300)] == \
        [(1, 1), (2, 2), (4, 2), (4, 2)]
    assert [shape(n, 1024, "high") for n in (16, 32, 1300)] == [(1, 1)] * 3
    assert plan(32, 1024, "high").smem_bytes == 213136
    assert plan(64, 512, "high").smem_bytes == 180368
    # HIGHEST keeps its own: all N rows at once where they fit, one team.
    assert TK.lstm_train_fwd_plan(64, 512) == TK.FwdPlan(4, 128, 64, 1, 4 * (4 * 4 * 512
                                                                             + 64 * 512))


@pytest.mark.parametrize("mode", MODES)
def test_fwd_mode_plan_refusals(mode):
    """No plan where not one slot fits: H=1024 at HIGH takes 213,136 bytes
    with one team, one slot and one buffer (one byte less and no plan); a
    smaller limit takes one team where two slots and two buffers do not
    fit; N=0, H not a multiple of 4 and H=2048 have none."""
    one = TK.lstm_train_fwd_plan(32, 1024, smem_limit=213136, precision="high")
    assert (one.stage_rows, one.teams) == (16, 1)
    with pytest.raises(ValueError, match="does not fit"):
        TK.lstm_train_fwd_plan(32, 1024, smem_limit=213135, precision="high")
    small = TK.lstm_train_fwd_plan(64, 512, smem_limit=60000, precision="default")
    assert (small.stage_rows, small.teams) == (16, 1)
    for n, h in ((0, 512), (16, 510), (16, 2048)):
        with pytest.raises(ValueError):
            TK.lstm_train_fwd_plan(n, h, precision=mode)


@pytest.mark.parametrize("n, h, units", [(17, 20, 2), (33, 36, 2), (7, 516, 4), (1, 48, 8)])
def test_fwd_exchange_round_trip(n, h, units):
    """h's bf16 hi and lo parts (``split_bf16``, the rounding of
    ``put_state``) through one slot of the exchange each: every element
    written exactly once (the owners' columns, the prologue's zeros), read
    back as the parts padded with zeros to 16-row chunks and Kp columns,
    and hi + lo as close to h as the split; the buffer has
    ``fwd_exchange_shape``'s size."""
    h_state = torch.from_numpy(np.random.RandomState(n + h).randn(n, h).astype(np.float32))
    parts = P.split_bf16(h_state)
    back = []
    for part in parts:
        ex = Exchange(n, h, units)
        ex.write(part.float().numpy())
        assert (ex.writes == 1).all() and not np.isnan(ex.x).any()
        want = np.zeros((ex.chunks * 16, kp16(h)), np.float32)
        want[:n, :h] = part.float().numpy()
        got = ex.read()
        np.testing.assert_array_equal(got, want)
        back.append(torch.from_numpy(got[:n, :h]))
    assert torch.equal(back[0] + back[1], parts[0].float() + parts[1].float())
    assert float((back[0] + back[1] - h_state).abs().max()) <= 2.0 ** -16 * float(
        h_state.abs().max())
    for mode, count in (("high", 2), ("default", 1)):
        shape = TK.fwd_exchange_shape(n, h, mode)
        assert shape == (2, count, ex.chunks, ex.ks, 256)
        assert np.prod(shape) == 2 * count * ex.x.size


# ---------------------------------------------------------------------------
# The ring's copies and waits (one item a chunk)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n, h", PLAN_SHAPES)
def test_fwd_ring_runs_the_plans(mode, n, h):
    """The ring under the plan of each shape, waiting for a chunk's issue
    where the kernel keeps the count, ends under several schedules, every
    copy in its slot when it is read and never over a slot still being
    read, no full mbarrier passed a phase early."""
    plan = TK.lstm_train_fwd_plan(n, h, precision=mode)
    chunks, stages = -(-n // 16), plan.stage_rows // 16
    for order in ring_schedules(n + h):
        assert ring_run(1, chunks, stages, plan.teams, plan.units, order=order,
                        wait_issued=count_needed(chunks, stages))


@pytest.mark.parametrize("teams", [1, 2])
def test_fwd_ring_every_slot_count(teams):
    """The ring ends for every slot count up to MAX_SLOTS and 1 to 7 chunks
    (two teams: two chunks and two slots at least, as the plan and the
    kernel's entry require), under several schedules, the count kept only
    where ``count_needed`` says: with an even slot count a slot's chunks
    stay with one team, whose warps read the chunk before, and with as many
    slots as chunks a slot's chunk before is of the step before."""
    for n_chunks in range(teams, 8):
        for stages in range(teams, TK.MAX_SLOTS + 1):
            for order in ring_schedules(n_chunks * 10 + stages):
                assert ring_run(1, n_chunks, stages, teams, 4, order=order,
                                wait_issued=count_needed(n_chunks, stages)), (n_chunks, stages)


@pytest.mark.parametrize("stages, n_chunks", [(3, 4), (5, 7), (5, 6)])
def test_fwd_ring_model_finds_an_early_parity(stages, n_chunks):
    """An odd slot count under the step's chunks (5 slots under N=100's
    seven at H=512 HIGH) alternates a slot's chunks between the two teams:
    where a warp waits for its chunk without waiting for its issue, a copy
    landing late lets a full mbarrier two phases behind pass by parity.
    Waiting for the issue, every schedule here ends clean."""
    plan = TK.lstm_train_fwd_plan(100, 512, precision="high")
    assert (plan.stage_rows // 16, plan.teams) == (5, 2) and count_needed(7, 5)
    assert count_needed(n_chunks, stages)
    assert not ends_clean(1, n_chunks, stages, 2, order="late", wait_issued=False)
    for order in ["late", None] + [np.random.RandomState(seed) for seed in range(8)]:
        assert ring_run(1, n_chunks, stages, 2, order=order)


# ---------------------------------------------------------------------------
# The write-once data flow


F, H, UNITS_FLOW = 10, 36, 2  # H % 16 != 0: columns past H are padding


def _fwd_case(n, seed):
    """x_proj (F, N, 4H), mask (a 0-length row and rows frozen by the mask
    from steps 7, 3 and 1 beside full rows where N > 1; at N = 1 one row of
    length 7), W_hh, h0, c0, as numpy."""
    rng = np.random.RandomState(seed)
    lengths = np.array([7]) if n == 1 else np.concatenate(
        [[F, 0, 7, F, 3, 1], rng.randint(0, F + 1, n - 6)])
    mask = (np.arange(F)[:, None] < lengths[None]).astype(np.float32)
    x_proj = (rng.randn(F, n, 4 * H) * 0.5).astype(np.float32)
    w_hh = ((rng.rand(H, 4 * H) * 2 - 1) * H ** -0.5).astype(np.float32)
    h0, c0 = (rng.randn(2, n, H) * 0.5).astype(np.float32)
    return x_proj, mask, w_hh, h0, c0


def _exchanged(h, mode):
    """h's bf16 parts through the exchange: written once by the owners
    (hi, and lo at high), read back by every block."""
    out = []
    for part in P.bf16_parts(h, mode):
        ex = Exchange(h.shape[0], H, UNITS_FLOW)
        ex.write(part.float().numpy())
        out.append(torch.from_numpy(ex.read()[:h.shape[0], :H]).to(torch.bfloat16))
    return out


def _write_once_flow(x_proj, mask, w_hh, h0, c0, mode, steps=F):
    """The forward sweep with the data flow of the mode body: h0's and then
    each step's selected h rounded once through the exchange, the product of
    those parts with W_hh's (``hi@Wh`` at default; ``hi@Wh + lo@Wh +
    hi@Wl`` at high, dot3's order), x_proj added, the cell in f32:
    (gates, h_all, c_all)."""
    w = P.weight_parts(w_hh, mode)
    h, c, a = h0, c0, _exchanged(h0, mode)
    gates_all, hs, cs = [], [], []
    for t in range(steps):
        prod = P.mm_bf16(a[0], w[0])
        if mode == "high":
            prod = prod + P.mm_bf16(a[1], w[0]) + P.mm_bf16(a[0], w[1])
        gates = x_proj[t] + prod
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        gates_all.append(gates)
        hs.append(h)
        cs.append(c)
        a = _exchanged(h, mode)  # the selected h, not h_new
    return torch.stack(gates_all), torch.stack(hs), torch.stack(cs)


def _bf16_dot(a, w):
    return lax.dot_general(a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                           (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _jax_fwd_default(x_proj, mask, w_hh, h0, c0):
    """``_make_fwd_kernel``'s recurrence as a JAX scan, its product with
    bf16 inputs and f32 sums: (gates, h_all, c_all)."""
    def step(carry, inp):
        hp, cp = carry
        xpt, m = inp
        gates = xpt + _bf16_dot(hp, w_hh)
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c_new = lax.logistic(f) * cp + lax.logistic(i) * jnp.tanh(g)
        h_new = lax.logistic(o) * jnp.tanh(c_new)
        m1 = m[:, None]
        h, c = jnp.where(m1 > 0, h_new, hp), jnp.where(m1 > 0, c_new, cp)
        return (h, c), (gates, h, c)
    _, out = lax.scan(step, (h0, c0), (x_proj, mask))
    return out


def _max_diff(got, want):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(got, want))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 17])
@pytest.mark.parametrize("mode", MODES)
def test_plain_fwd_is_the_write_once_data_flow(mode, n, seed):
    """``lstm_train_fwd_plain`` (and the wrapper on CPU tensors, also
    without the gates) at the mode equals the write-once data flow bit for
    bit; the 0-length row keeps h0, c0 bit for bit and rows frozen by the
    mask keep their state; the flow lies within the JAX references'
    tolerances at the mode (at HIGH ``_pallas_fwd`` in interpret mode, and
    closer to it than the plain version at HIGHEST)."""
    case = _fwd_case(n, seed)
    args = tuple(torch.from_numpy(a) for a in case)
    flow = _write_once_flow(*args, mode)
    for got in (TK.lstm_train_fwd_plain(*args, True, mode), TK.lstm_train_fwd(*args, True, mode)):
        assert all(torch.equal(a, b) for a, b in zip(got, flow))
    primal = TK.lstm_train_fwd(*args, False, mode)
    assert primal[0] is None and torch.equal(primal[1], flow[1]) and torch.equal(primal[2],
                                                                                 flow[2])
    x_proj, mask, w_hh, h0, c0 = args
    lengths = mask.sum(0).long().tolist()
    for row, length in enumerate(lengths):
        if length == 0:
            assert torch.equal(flow[1][:, row], h0[row].expand(F, -1))
            assert torch.equal(flow[2][:, row], c0[row].expand(F, -1))
    row = 0 if n == 1 else 2  # frozen from step 7 on
    short = _write_once_flow(x_proj[:7], mask[:7], w_hh, h0, c0, mode, 7)
    assert torch.equal(flow[1][7:, row], short[1][6, row].expand(F - 7, -1))
    assert torch.equal(flow[1][:7, row], short[1][:, row])
    jcase = [jnp.asarray(a) for a in case]
    m3 = jcase[1][:, :, None]
    if mode == "high":
        whi, wlo = JK.split_bf16(jcase[2])
        want = JT._pallas_fwd(jcase[0], m3, whi, wlo, jcase[3], jcase[4], hidden=H,
                              interpret=True, precision=lax.Precision.HIGH)
        err = _max_diff(flow, want)
        assert err <= FWD_HIGH_TOL["atol"], err
        assert err < _max_diff(TK.lstm_train_fwd_plain(*args, True, "highest"), want)
    else:
        err = _max_diff(flow, _jax_fwd_default(*jcase))
        assert err <= DEFAULT_EMUL_TOL["atol"], err
        want = JT._pallas_fwd(jcase[0], m3, jcase[2], jcase[3], jcase[4], hidden=H,
                              interpret=True, precision=lax.Precision.DEFAULT)
        err = _max_diff(flow, want)
        assert err <= BF16_TOL["atol"], err
