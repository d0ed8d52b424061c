"""The LSTM stack kernel's HIGH and DEFAULT body in the stack order, on the CPU.

The kernel (``csrc/lstm_stack.cu`` ``ring_body``) cannot run here, so this
file holds what surrounds it against what it must be:

* its launch plan at ``high`` and ``default`` (``lstm_stack_plan``,
  ``stack_ring_smem_bytes``): the grid, the ring of one state's 16-row bf16
  chunks that bulk copies fill (as many slots as fit beside the resident B
  fragments, up to MAX_SLOTS and a phase's chunks), the two teams of 4
  warps, the shared-memory formula, and the refusals;
* a numpy model of its exchange buffer: two slots a layer of 16x16 k-step
  tiles (``stack_exchange_shape``), each element written once by its owner,
  zeros past N and past H, read back as ``ldmatrix`` reads A fragments; and
  the schedule of the slots over the phases of the stack order (two a layer
  suffice);
* a model of its ring's copies and waits (``ring_phases``), one actor a
  warp, copies landing in any order: every plan's ring ends, no copy is
  read before it lands or lands over a slot being read, and no full
  mbarrier passes by parity a phase early; with two teams on too few
  slots, or without the wait for the issue, it deadlocks or reads early;
  the count of the items issued is needed exactly where ``count_needed``
  keeps it (a slot's items change team), and which plans keep it;
* the write-once data flow at both modes: each layer's selected state (h_new
  where the mask is 1, the old h where it is 0) rounded once into bf16 (hi,
  and lo at high) through that exchange, read back by every block, then
  multiplied (at layer l >= 1 the input product of layer l - 1's state
  scaled by the rows' mask): bit for bit ``lstm_stack_plain`` at the mode,
  with rows frozen by the mask and a 0-length row; and within its tolerance
  of the JAX ``_pallas_forward`` in interpret mode at HIGH and DEFAULT (and
  at DEFAULT tightly of a JAX scan with bf16 products).

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
from tests.torch_ring_model import (StackExchange, count_needed, count_rule_check, ends_clean,
                                     ring_run, ring_schedules)

torch.set_num_threads(1)

MODES = ("high", "default")
LIMIT = 232448  # the H100's opt-in shared memory per block (K.SMEM_LIMIT)


def _kp(h):
    return -(-h // 16) * 16


def _expected_plan(layers, n, h, mode, limit=LIMIT):
    """(units, stages, teams, shared bytes) by the layout of
    ``ring_smem_bytes``: B fragments of the 2L - 1 matrices (parts x 8 U Kp
    bytes each), the ring (16 rows x Kp bf16 a part a slot), the mbarriers
    and the count of items issued (144 bytes), two buffers of 8 warps' 16 x
    4U f32 partial tiles."""
    parts = 2 if mode == "high" else 1
    units = 4 if h // 4 <= K.SMS else 8
    fixed = (2 * layers - 1) * parts * 8 * units * _kp(h) + 144 + 2 * 8 * 16 * 4 * units * 4
    slot = 16 * parts * _kp(h) * 2
    chunks = -(-n // 16)
    stages = min(K.MAX_SLOTS, chunks * min(layers, 2), (limit - fixed) // slot)
    teams = 2 if chunks > 1 and stages > min(layers, 2) else 1
    return units, stages, teams, fixed + stages * slot


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers, n, h", [(2, 1, 512), (2, 16, 512), (2, 17, 512), (2, 64, 512),
                                          (2, 1300, 512), (1, 1, 1024), (1, 64, 1024),
                                          (1, 20, 1000), (3, 7, 64), (2, 300, 260), (1, 5, 40),
                                          (2, 33, 40)])
def test_stack_mode_plan(mode, layers, n, h):
    """The plan at the mode in the stack order: HIGHEST's grid (U=4 where H
    / 4 blocks fit, else U=8 for one layer), a ring of as many of one
    state's 16-row chunks as fit beside the fragments, up to MAX_SLOTS and
    a phase's chunks (two states a chunk from 2 layers on), two teams where
    a phase has two chunks or more and the ring two slots, and the layout's
    bytes."""
    units, stages, teams, smem = _expected_plan(layers, n, h, mode)
    plan = K.lstm_stack_plan(layers, n, h, precision=mode)
    assert plan == K.StackPlan(units, h // units, min(layers, 2), 16 * stages, teams, smem)
    assert plan.smem_bytes == K.stack_ring_smem_bytes(units, h, layers, stages, mode) <= LIMIT
    assert 1 <= stages <= K.MAX_SLOTS
    highest = K.lstm_stack_plan(layers, n, h)
    assert (plan.units, plan.blocks) == (highest.units, highest.blocks)  # HIGHEST's grid


def test_stack_mode_plan_slots_and_teams():
    """The ring by shape: at 2x512 DEFAULT the fragments take 48 KB and a
    slot 16 KB, so every item of a phase up to 8 is in flight (N=64: 4
    chunks of two states); HIGH's fragments and slots are twice as large: 3
    slots, and two teams (so has the wavefront order at two layers);
    one layer of 1024: 4 slots at DEFAULT, 1 at HIGH (128 KB of fragments),
    one team."""
    plan = lambda layers, n, h, mode: K.lstm_stack_plan(layers, n, h, precision=mode)
    stages = lambda *a: plan(*a).stage_rows // 16
    assert [stages(2, n, 512, "default") for n in (1, 16, 17, 33, 64, 1300)] == [2, 2, 4, 6, 8, 8]
    assert [stages(2, n, 512, "high") for n in (1, 16, 17, 64, 1300)] == [2, 2, 3, 3, 3]
    assert [stages(1, n, 1024, "default") for n in (1, 17, 64, 1300)] == [1, 2, 4, 4]
    assert [stages(1, n, 1024, "high") for n in (1, 17, 64, 1300)] == [1, 1, 1, 1]
    assert plan(2, 64, 512, "high").teams == 2
    assert K.lstm_stack_plan(2, 64, 512, wavefront=True, precision="high").teams == 2
    assert [plan(2, n, 512, "default").teams for n in (1, 16, 17)] == [1, 1, 2]
    assert plan(1, 64, 1024, "default").teams == 2 and plan(1, 64, 1024, "high").teams == 1
    assert plan(2, 64, 512, "high").smem_bytes == 213136
    assert plan(1, 64, 1024, "high").smem_bytes == 229520


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers, n, h, sms", [(2, 64, 1024, 132), (2, 0, 512, 132),
                                               (2, 4, 510, 132), (2, 64, 512, 100),
                                               (1, 4, 4096, 132)])
def test_stack_mode_plan_refusals(mode, layers, n, h, sms):
    """No plan where HIGHEST has none: 2x1024 (U=8 runs one layer), N=0, H
    not a multiple of 4, 2x512 on 100 SMs, one layer of 4096 (no U puts its grid
    on the SMs)."""
    with pytest.raises(ValueError):
        K.lstm_stack_plan(layers, n, h, sms, precision=mode)
    assert not K.lstm_stack_fits(layers, h, sms, precision=mode) or n <= 0


def test_stack_mode_plan_needs_one_slot():
    """One layer of 1024 at HIGH takes 229,520 bytes with one slot: one byte
    less and no plan; at DEFAULT a smaller limit takes fewer slots and, at
    one slot, one team."""
    K.lstm_stack_plan(1, 64, 1024, smem_limit=229520, precision="high")
    with pytest.raises(ValueError, match="does not fit"):
        K.lstm_stack_plan(1, 64, 1024, smem_limit=229519, precision="high")
    one = K.lstm_stack_plan(2, 64, 512, smem_limit=90000, precision="default")
    assert (one.stage_rows, one.teams) == (16, 1)
    assert K.lstm_stack_plan(2, 64, 512, smem_limit=120000, precision="default").stage_rows == 48


# ---------------------------------------------------------------------------
# A numpy model of the exchange buffer


@pytest.mark.parametrize("layers, n, h, units", [(1, 17, 40, 4), (2, 17, 40, 4), (2, 1, 40, 4),
                                                 (2, 33, 64, 8), (1, 7, 36, 4)])
def test_stack_exchange_round_trip(layers, n, h, units):
    """Every element of both slots of every layer is written exactly once
    (the prologue's zeros and h0, then one state per layer into slot 1),
    the chunks read back are each state padded with zeros to 16-row chunks
    and Kp columns, and the buffer has ``stack_exchange_shape``'s size."""
    rng = np.random.RandomState(n + h + layers)
    h0 = rng.randn(layers, n, h).astype(np.float32)
    state = rng.randn(layers, n, h).astype(np.float32)
    ex = StackExchange(layers, n, h, units, h0)
    for l in range(layers):
        ex.write(1, l, state[l])
    assert (ex.writes == 1).all() and not np.isnan(ex.x).any()
    for sl, values in ((0, h0), (1, state)):
        for l in range(layers):
            want = np.zeros((ex.chunks * 16, _kp(h)), np.float32)
            want[:n, :h] = values[l]
            np.testing.assert_array_equal(ex.read(sl, l), want)
    for mode, parts in (("high", 2), ("default", 1)):
        shape = K.stack_exchange_shape(layers, n, h, mode)
        assert shape == (2, layers, parts, ex.chunks, ex.ks, 256)
        assert np.prod(shape) == ex.x.size * parts


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_two_slots_a_layer_suffice(layers):
    """In the stack order, phase (t, l) reads layer l's state after t - 1
    from slot t & 1 and layer l - 1's after t from slot (t + 1) & 1, and
    writes layer l's after t into slot (t + 1) & 1: every read finds the
    state it needs (the last write to that slot before the phase), no phase
    reads a slot it writes, and a slot is next written only after every
    phase that reads its state (the grid barriers between them wait for the
    reads' copies)."""
    f = 5
    phases = [(t, l) for t in range(f) for l in range(layers)]
    holds = {(0, l): -1 for l in range(layers)}  # (slot, layer) -> the step whose state it holds
    last_read = {}
    for p, (t, l) in enumerate(phases):
        reads = {(t & 1, l): t - 1}
        if l > 0:
            reads[((t + 1) & 1, l - 1)] = t
        written = ((t + 1) & 1, l)
        for key, tau in reads.items():
            assert holds.get(key) == tau
            last_read[key, tau] = p
        assert written not in reads
        old = holds.get(written)
        if old is not None:  # every read of the state it held is done
            assert all(q < p for (k, tau), q in last_read.items() if k == written and tau == old)
        holds[written] = t


# ---------------------------------------------------------------------------
# A model of the ring's copies and waits (tests/torch_ring_model.py)


@pytest.mark.parametrize("layers, n, h, mode", [
    (layers, n, h, mode) for mode in MODES
    for layers, n, h in [(3, 48, 448), (4, 48, 352), (2, 64, 512), (2, 17, 512), (2, 100, 512),
                         (1, 64, 1024), (1, 17, 1024), (3, 7, 64), (2, 20, 260)]
] + [(6, 33, 512, "default"), (6, 48, 512, "default")])
def test_ring_issue_order_runs_the_plans(layers, n, h, mode):
    """The ring under the plan of each shape (among them two teams with two
    slots and two items a chunk: 3x448 and 4x352 at HIGH, 6x512 at DEFAULT,
    N = 33 and 48) ends under several schedules, every copy in its slot
    when it is read and never over a slot still being read."""
    plan = K.lstm_stack_plan(layers, n, h, precision=mode)
    n_chunks, stages = -(-n // 16), plan.stage_rows // 16
    for order in ring_schedules(layers + n + h):
        assert ring_run(layers, n_chunks, stages, plan.teams, plan.units, order=order)


@pytest.mark.parametrize("teams", [1, 2])
@pytest.mark.parametrize("layers, units", [(1, 4), (1, 8), (2, 4), (3, 4)])
def test_ring_issue_order_every_slot_count(layers, units, teams):
    """The ring ends for every slot count up to MAX_SLOTS (with two teams
    more slots than a chunk has items, as the plan and the kernel's entry
    require) and 1 to 6 chunks, with and without the reuse of two layers,
    under several schedules."""
    first = 1 if teams == 1 else min(layers, 2) + 1
    for n_chunks in range(1, 7):
        for stages in range(first, K.MAX_SLOTS + 1):
            for order in ring_schedules(n_chunks * 10 + stages):
                assert ring_run(layers, n_chunks, stages, teams, units, order=order), \
                    (n_chunks, stages)


def test_ring_two_teams_need_more_slots_than_items_a_chunk():
    """Thread 0 issues the copies after its own products. Two teams on two
    slots with two items a chunk and three chunks fail: team 0's item 2c +
    4 sits behind item 2c + 2, which team 1 takes, so no product of team 0
    issues it, and thread 0's warp, which does not wait for the issue,
    passes its slot's mbarrier early or waits for ever. So the plan of
    3x448 N=48 at HIGH, two slots, has one team, and three slots with two
    teams end; at one layer (one item a chunk) two slots take two teams."""
    plan = K.lstm_stack_plan(3, 48, 448, precision="high")
    assert (plan.stage_rows // 16, plan.teams) == (2, 1)
    for order in ring_schedules(0):
        assert not ends_clean(3, 3, 2, 2, order=order)
    assert ring_run(3, 3, 2, 1) and ring_run(3, 3, 3, 2)
    assert K.lstm_stack_plan(1, 17, 1024, precision="default")[3:5] == (32, 2)  # two slots


def test_ring_model_finds_an_early_parity():
    """Where a warp waits for its item without waiting for its issue, at
    2x512 N=64 at HIGH (three slots, two teams) a copy landing late lets a
    full mbarrier two phases behind pass by parity: team 1 takes item 3
    while item 0, before it in the slot, is in flight. Waiting for the
    issue, every schedule here ends clean."""
    plan = K.lstm_stack_plan(2, 64, 512, precision="high")
    assert (plan.stage_rows // 16, plan.teams) == (3, 2)
    with pytest.raises(AssertionError):
        ring_run(2, 4, 3, 2, order="late", wait_issued=False)
    for order in ["late", None] + [np.random.RandomState(seed) for seed in range(8)]:
        assert ring_run(2, 4, 3, 2, order=order)


@pytest.mark.parametrize("stages", range(1, K.MAX_SLOTS + 1))
@pytest.mark.parametrize("layers", [1, 2])
def test_count_rule_matches_the_ring_model(layers, stages):
    """The count of the items issued, kept per phase where ``count_needed``
    says (the kernel's rule): on the plan's teams the ring ends clean under
    every schedule for 1 to 9 chunks; with the count dropped at the phases
    of one item count a chunk alone, a schedule fails exactly where the rule
    keeps it there, and none elsewhere. One layer: one item a chunk; two:
    two at layer 1, one at layer 0."""
    for n_chunks in range(1, 10):
        for ipc, (kept, fails) in count_rule_check(layers, n_chunks, stages).items():
            assert fails == kept, (n_chunks, ipc, kept, fails)


@pytest.mark.parametrize("layers, n_chunks, stages, ipc", [(1, 4, 3, 1), (2, 4, 3, 1),
                                                           (2, 4, 3, 2), (2, 5, 6, 2)])
def test_ring_model_finds_the_fault_without_the_count(layers, n_chunks, stages, ipc):
    """A case for each item count a chunk where the rule keeps the count
    (three slots: odd; six at two items a chunk: 2 mod 4): without it at
    those phases a full mbarrier two phases behind passes by parity."""
    assert count_rule_check(layers, n_chunks, stages)[ipc] == (True, True)


@pytest.mark.parametrize("mode, layers, n, h, keeps", [
    ("high", 2, 64, 512, {1, 2}), ("high", 2, 17, 512, {2}), ("high", 2, 1300, 512, {1, 2}),
    ("default", 2, 100, 512, set()), ("default", 2, 1300, 512, set()),
    ("default", 1, 64, 1024, set()), ("default", 1, 1300, 1024, set()),
    ("high", 1, 64, 1024, set()), ("default", 2, 300, 260, set()), ("high", 2, 300, 260, set())])
def test_stack_plans_keep_the_count_where_a_slot_changes_team(mode, layers, n, h, keeps):
    """The item counts a chunk (1 at layer 0, 2 above) whose phases keep the
    count on the plan: 2x512 at HIGH (three slots, two teams) keeps it; two
    teams on an even slot count (2x512 at DEFAULT past N=64, 8 slots; one
    layer of 1024 at DEFAULT, 4; 2x260, 8) drop it; one team (1x1024 at
    HIGH) and the reuse of two layers have none."""
    plan = K.lstm_stack_plan(layers, n, h, precision=mode)
    stages, chunks = plan.stage_rows // 16, -(-n // 16)
    reuse = layers == 2 and stages >= 2 * chunks
    counted = {k for k in ({1, 2} if layers > 1 else {1})
               if plan.teams == 2 and not reuse and count_needed(chunks, stages, k)}
    assert counted == keeps


# ---------------------------------------------------------------------------
# The write-once data flow


F, H, L, UNITS = 10, 40, 2, 4  # H % 16 != 0: columns past H are padding


def _stack_case(n, seed):
    """x0_proj (F, N, 4H), mask (a 0-length row and rows frozen by the mask
    from steps 7, 3 and 1 where N > 1; at N = 1 one row of length 7),
    w_hh (L, H, 4H), w_ih_up (L - 1, H, 4H), b_up (L - 1, 4H), h0, c0, as
    numpy."""
    rng = np.random.RandomState(seed)
    lengths = np.array([7]) if n == 1 else np.concatenate(
        [[F, 0, 7, F, 3, 1], rng.randint(0, F + 1, n - 6)])
    mask = (np.arange(F)[:, None] < lengths[None]).astype(np.float32)
    x0_proj = (rng.randn(F, n, 4 * H) * 0.5).astype(np.float32)
    w = ((rng.rand(2 * L - 1, H, 4 * H) * 2 - 1) * H ** -0.5).astype(np.float32)
    b_up = ((rng.rand(L - 1, 4 * H) * 2 - 1) * H ** -0.5).astype(np.float32)
    h0, c0 = (rng.randn(2, L, n, H) * 0.5).astype(np.float32)
    return x0_proj, mask, w[:L], w[L:], b_up, h0, c0


def _product(parts, w, mode):
    """A product of an operand's bf16 parts with a weight's: ``hi@Wh`` at
    default, ``hi@Wh + lo@Wh + hi@Wl`` at high (dot3's order)."""
    out = P.mm_bf16(parts[0], w[0])
    if mode == "high":
        out = out + P.mm_bf16(parts[1], w[0]) + P.mm_bf16(parts[0], w[1])
    return out


def _write_once_flow(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, mode, steps=F):
    """The stack with the data flow of the mode body: each layer's h0 and
    then its selected state after each step rounded once into bf16 parts
    (split_bf16: hi, and lo at high) through the exchange's two slots a
    layer, in the phases of the stack order; phase (t, l) multiplies the
    parts it reads back, layer l - 1's state after t by W_ih[l] (scaled by
    the rows' mask: the input is h_new * mask) and layer l's after t - 1 by
    W_hh[l]; the gates' sums in the plain version's order, the cell in f32.

    The CPU's f32 GEMM sums a one-row product in another order than a
    many-row one, so the input product goes through a product of the plain
    version's shape (its one projection of all F steps: the step's rows,
    the others zero), whose rows come out each on its own."""
    n = x0_proj.shape[1]
    w_hh_p = [P.weight_parts(w, mode) for w in w_hh]
    w_up_p = [P.weight_parts(w, mode) for w in w_ih_up]
    exchange = [StackExchange(L, n, H, UNITS, P.bf16_parts(h0, mode)[i].float().numpy())
                for i in range(2 if mode == "high" else 1)]

    def read(sl, l):
        return [torch.from_numpy(ex.read(sl, l)[:n, :H]).to(torch.bfloat16) for ex in exchange]

    h, c = list(h0.unbind(0)), list(c0.unbind(0))
    outs = []
    for t in range(steps):
        m = mask[t][:, None]
        for l in range(L):
            rec = _product(read(t & 1, l), w_hh_p[l], mode)
            if l == 0:
                gates = x0_proj[t] + rec
            else:
                rows = [torch.zeros(steps * n, H, dtype=torch.bfloat16) for _ in exchange]
                for part, got in zip(rows, read((t + 1) & 1, l - 1)):
                    part[t * n:(t + 1) * n] = got
                inp = _product(rows, w_up_p[l - 1], mode)[t * n:(t + 1) * n]
                gates = (inp * m + b_up[l - 1]) + rec
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            h[l] = torch.where(m > 0, h_new, h[l])
            c[l] = torch.where(m > 0, c_new, c[l])
            for ex, part in zip(exchange, P.bf16_parts(h[l], mode)):  # the selected state
                ex.write((t + 1) & 1, l, part.float().numpy())
            if l == L - 1:
                outs.append(h_new * m)
    return torch.stack(outs), torch.stack(h), torch.stack(c)


def _bf16_dot(a, w):
    return lax.dot_general(a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                           (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _jax_stack_default(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0):
    """``_make_kernel``'s recurrence as a JAX scan over time, every product
    with bf16 inputs and f32 sums: (outs, hF, cF)."""
    def step(carry, inp):
        hs, cs = carry
        xpt, m = inp
        m1 = m[:, None]
        prev_out, new_h, new_c = None, [], []
        for l in range(L):
            x_in = xpt if l == 0 else _bf16_dot(prev_out, w_ih_up[l - 1]) + b_up[l - 1]
            gates = x_in + _bf16_dot(hs[l], w_hh[l])
            i, f, g, o = jnp.split(gates, 4, axis=-1)
            c_new = lax.logistic(f) * cs[l] + lax.logistic(i) * jnp.tanh(g)
            h_new = lax.logistic(o) * jnp.tanh(c_new)
            new_h.append(jnp.where(m1 > 0, h_new, hs[l]))
            new_c.append(jnp.where(m1 > 0, c_new, cs[l]))
            prev_out = h_new * m1
        return (jnp.stack(new_h), jnp.stack(new_c)), prev_out
    (hF, cF), outs = lax.scan(step, (h0, c0), (x0_proj, mask))
    return outs, hF, cF


def _max_diff(got, want):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(got, want))


# The JAX references at the mode (the flow is the plain version's bits;
# readings over seeds 0-7 at N = 1 and 17):
# * HIGH, ``_pallas_forward`` in interpret mode (dot3 of the same bf16
#   splits, f32 sums in another order): up to 3.1e-7, the plain version at
#   HIGHEST 6.4e-7 or more away; about 2x the largest reading;
# * DEFAULT, the bf16 scan above (the same bf16 products; a 1-ulp
#   difference in h can round an element of the next step's bf16 h the
#   other way): up to 1.0e-5; about 2x;
# * DEFAULT, ``_pallas_forward`` in interpret mode: on the CPU its DEFAULT
#   dot runs in f32, so it lies bf16's rounding away (up to 1.7e-3;
#   BF16_TOL of tests/test_torch_precision.py).
JAX_TOL = {"high": 6e-7, "default": 2e-5}
PALLAS_DEFAULT_TOL = 5e-3


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 17])
@pytest.mark.parametrize("mode", MODES)
def test_plain_stack_is_the_write_once_data_flow(mode, n, seed):
    """``lstm_stack_plain`` (and the wrapper on CPU tensors) at the mode
    equals the write-once data flow bit for bit; rows frozen by the mask
    and the 0-length row keep their state bit for bit; the flow lies within
    JAX_TOL of the JAX reference at the mode (at HIGH ``_pallas_forward`` in
    interpret mode, closer to it than the plain version at HIGHEST; at
    DEFAULT a JAX scan with bf16 products) and at DEFAULT within
    PALLAS_DEFAULT_TOL of ``_pallas_forward`` in interpret mode."""
    case = _stack_case(n, seed)
    args = tuple(torch.from_numpy(a) for a in case)
    flow = _write_once_flow(*args, mode)
    for got in (K.lstm_stack_plain(*args, mode), K.lstm_stack_fused(*args, mode)):
        assert all(torch.equal(a, b) for a, b in zip(got, flow))
    x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0 = args
    lengths = mask.sum(0).long().tolist()
    for row, length in enumerate(lengths):
        if length == 0:  # the 0-length row: its state untouched, zero outputs
            assert torch.equal(flow[1][:, row], h0[:, row])
            assert torch.equal(flow[2][:, row], c0[:, row])
            assert (flow[0][:, row] == 0).all()
    if n == 1 or lengths[2] == 7:  # frozen from step 7 on
        row = 0 if n == 1 else 2
        short = _write_once_flow(x0_proj[:7], mask[:7], w_hh, w_ih_up, b_up, h0, c0, mode, 7)
        assert torch.equal(flow[1][:, row], short[1][:, row])
        assert torch.equal(flow[2][:, row], short[2][:, row])
    jcase = [jnp.asarray(a) for a in case]
    pallas = lambda precision: JK._pallas_forward(
        jcase[0], jcase[1][:, :, None], jcase[2], jcase[3], jcase[4][:, None], jcase[5],
        jcase[6], num_layers=L, hidden=H, interpret=True, precision=precision)
    if mode == "high":
        want = pallas(lax.Precision.HIGH)
        err = _max_diff(flow, want)
        assert err <= JAX_TOL[mode], err
        assert err < _max_diff(K.lstm_stack_plain(*args, "highest"), want)
    else:
        err = _max_diff(flow, _jax_stack_default(*jcase))
        assert err <= JAX_TOL[mode], err
        err = _max_diff(flow, pallas(lax.Precision.DEFAULT))
        assert err <= PALLAS_DEFAULT_TOL, err
