"""The LSTM stack kernel's HIGH and DEFAULT body in the wavefront order, on the CPU.

The kernel (``csrc/lstm_stack.cu`` ``ring_body`` with ``kWave``) cannot run
here, so this file holds what surrounds it against what it must be:

* its launch plan at ``high`` and ``default`` (``lstm_stack_plan(...,
  wavefront=True)``): the stack order's grid and ring, with a chunk of a
  phase holding up to L items (each staged state once), so two teams of 4
  warps only where the ring has more than L slots; the shared-memory
  formula (``stack_ring_smem_bytes``); a mode plan wherever HIGHEST stages
  a 16-row chunk;
* the schedule of the exchange's two slots a layer over the wavefront's
  phases: two suffice;
* a model of its ring's copies and waits (``tests/torch_ring_model.py``),
  items held from their first use to their last (layer k's state by
  W_hh[k], then as layer k + 1's input by W_ih[k + 1]): every plan's ring
  ends; the count of the items issued is needed exactly where
  ``count_needed`` keeps it, at 1 to MAX_SLOTS slots, 1 to 9 chunks and L =
  2-4;
* the write-once data flow at both modes: each layer's selected state
  rounded once into bf16 (hi, and lo at high) through that exchange in the
  wavefront's phases, read back as ``ldmatrix`` reads it, is bit for bit
  the operand of ``lstm_stack_wavefront_plain`` at the mode (its input rows
  scaled by the mask: the previous layer's output h_new * mask); so the
  flow equals the plain version bit for bit, with 0-length rows frozen, and
  lies within the tolerances of ``tests/test_torch_precision.py`` of the
  JAX ``_pallas_wavefront`` in interpret mode at HIGH and of the JAX
  references at DEFAULT.

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
from tests.test_torch_precision import (BF16_TOL, DEFAULT_EMUL_TOL, HIGH_TOL, _assert_close,
                                        _high_inputs, _max_diff, _stack_scan_bf16, _t, _t_cell)
from tests.torch_ring_model import (StackExchange, count_rule_check, ring_run, ring_schedules,
                                    stack_phases)

torch.set_num_threads(1)

MODES = ("high", "default")
LIMIT = 232448  # the H100's opt-in shared memory per block (K.SMEM_LIMIT)


def _kp(h):
    return -(-h // 16) * 16


def _expected_plan(layers, n, h, mode, limit=LIMIT):
    """(stages, teams, shared bytes) by the layout of ``ring_smem_bytes``
    (U=4): B fragments of the 2L - 1 matrices (parts x 32 Kp bytes each),
    the ring (16 rows x Kp bf16 a part a slot), the mbarriers and the count
    of items issued (144 bytes), two buffers of 8 warps' 16 x 16 f32
    partial tiles; up to L items a chunk."""
    parts = 2 if mode == "high" else 1
    fixed = (2 * layers - 1) * parts * 32 * _kp(h) + 144 + 2 * 8 * 16 * 16 * 4
    slot = 16 * parts * _kp(h) * 2
    chunks = -(-n // 16)
    stages = min(K.MAX_SLOTS, chunks * layers, (limit - fixed) // slot)
    return stages, 2 if chunks > 1 and stages > layers else 1, fixed + stages * slot


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers, n, h", [(2, 1, 512), (2, 16, 512), (2, 17, 512), (2, 64, 512),
                                          (2, 1300, 512), (3, 1, 448), (3, 17, 448),
                                          (3, 48, 448), (3, 64, 448), (4, 1, 352), (4, 48, 352),
                                          (4, 64, 352), (3, 7, 64), (2, 300, 260)])
def test_wave_mode_plan(mode, layers, n, h):
    """The plan at the mode in the wavefront order: HIGHEST's grid (U=4),
    a ring of as many of one state's 16-row chunks as fit beside the
    fragments, up to MAX_SLOTS and a phase's items (L a chunk), two teams
    where a phase has two chunks or more and the ring more than L slots,
    and the layout's bytes, the stack order's formula."""
    stages, teams, smem = _expected_plan(layers, n, h, mode)
    plan = K.lstm_stack_plan(layers, n, h, wavefront=True, precision=mode)
    assert plan == K.StackPlan(4, h // 4, layers, 16 * stages, teams, smem)
    assert plan.smem_bytes == K.stack_ring_smem_bytes(4, h, layers, stages, mode) <= LIMIT
    assert 1 <= stages <= K.MAX_SLOTS


def test_wave_mode_plan_slots_and_teams():
    """The ring by shape. 2x512: the stack order's plan (two items a chunk
    in both orders): DEFAULT 8 slots from N=64 and two teams from N=17,
    HIGH 3 slots and two teams from N=17 (the parent body held one team of
    8 warps there, two teams' staged planes not fitting). 3x448 and 4x352:
    DEFAULT 8 slots and two teams; HIGH two slots and one team (a chunk's
    L items need more than L slots for two)."""
    plan = lambda layers, n, h, mode: K.lstm_stack_plan(layers, n, h, wavefront=True,
                                                        precision=mode)
    rows = lambda layers, h, mode, ns: [(plan(layers, n, h, mode).stage_rows // 16,
                                         plan(layers, n, h, mode).teams) for n in ns]
    ns = (1, 16, 17, 64, 1300)
    assert rows(2, 512, "default", ns) == [(2, 1), (2, 1), (4, 2), (8, 2), (8, 2)]
    assert rows(2, 512, "high", ns) == [(2, 1), (2, 1), (3, 2), (3, 2), (3, 2)]
    assert rows(3, 448, "default", (1, 17, 48, 64)) == [(3, 1), (6, 2), (8, 2), (8, 2)]
    assert rows(3, 448, "high", (1, 17, 48, 64)) == [(2, 1), (2, 1), (2, 1), (2, 1)]
    assert rows(4, 352, "default", (1, 17, 48, 64)) == [(4, 1), (8, 2), (8, 2), (8, 2)]
    assert rows(4, 352, "high", (1, 17, 48, 64)) == [(2, 1), (2, 1), (2, 1), (2, 1)]
    assert plan(2, 64, 512, "high").smem_bytes == 213136
    assert plan(2, 64, 512, "default").smem_bytes == 196752
    assert plan(3, 48, 448, "high").smem_bytes == 217232
    assert plan(4, 48, 352, "high").smem_bytes == 219280


@pytest.mark.parametrize("layers", [2, 3, 4, 5])
def test_every_highest_wavefront_plan_has_a_mode_plan(layers):
    """Wherever HIGHEST plans the wavefront order with a 16-row chunk at
    least (on 132 SMs, or on 100: none at 2x512), both modes plan it too,
    on the same grid. Where HIGHEST stages fewer rows (all N < 16 at once
    beside columns that nearly fill the block: from 4 layers, e.g. 4x448 N
    <= 4), a ring slot holds 16 rows and two buffers of partials, and at
    HIGH no plan fits, as none did for the body before the ring. Where
    HIGHEST refuses the grid (2x1024: U=8 runs one layer), so do the
    modes."""
    for sms in (132, 100):
        for h in range(16, 1040, 36):
            for n in (1, 4, 17, 64, 1300):
                try:
                    highest = K.lstm_stack_plan(layers, n, h, sms, wavefront=True)
                except ValueError:
                    if h // 4 > sms:
                        for mode in MODES:
                            with pytest.raises(ValueError, match="does not fit"):
                                K.lstm_stack_plan(layers, n, h, sms, wavefront=True,
                                                  precision=mode)
                    continue
                for mode in MODES:
                    try:
                        plan = K.lstm_stack_plan(layers, n, h, sms, wavefront=True,
                                                 precision=mode)
                    except ValueError:
                        assert (mode, highest.stage_rows < 16) == ("high", True) and layers >= 4
                        continue
                    assert (plan.units, plan.blocks) == (highest.units, highest.blocks)


@pytest.mark.parametrize("layers", [2, 3, 4])
def test_two_slots_a_layer_suffice_in_the_wavefront_order(layers):
    """In the wavefront order phase p reads layer k's state after p - k - 1
    (k = max(0, l_first - 1) ... l_last: layer k's recurrent operand and
    layer k + 1's input) from slot (p - k) & 1 of layer k, and writes each
    active layer l's state after p - l into slot (p - l + 1) & 1: every read
    finds the state it needs (the last write to that slot before the
    phase), no phase reads a slot it writes, and a slot is next written
    only after every phase that reads its state (the grid barriers between
    them wait for the reads' copies). Each state is read at one phase
    only."""
    f = 5
    holds = {(0, k): -1 for k in range(layers)}  # (slot, layer) -> the step whose state it holds
    reads_of = {}
    for p, l_first, l_last in stack_phases(layers, f, wavefront=True):
        reads = {((p - k) & 1, k): p - k - 1 for k in range(max(0, l_first - 1), l_last + 1)}
        writes = {((p - l + 1) & 1, l): p - l for l in range(l_first, l_last + 1)}
        for key, tau in reads.items():
            assert holds.get(key) == tau
            reads_of.setdefault((key, tau), set()).add(p)
        assert not set(reads) & set(writes)
        for key, tau in writes.items():
            old = holds.get(key)
            if old is not None:  # every read of the state it held is done
                assert all(q < p for q in reads_of.get((key, old), ()))
            holds[key] = tau
    assert all(len(ps) == 1 for ps in reads_of.values())


# ---------------------------------------------------------------------------
# A model of the ring's copies and waits (tests/torch_ring_model.py)


@pytest.mark.parametrize("layers, n, h, mode", [
    (layers, n, h, mode) for mode in MODES
    for layers, n, h in [(2, 64, 512), (2, 17, 512), (2, 100, 512), (2, 1, 512), (3, 48, 448),
                         (3, 64, 448), (4, 48, 352), (4, 100, 352), (3, 7, 64), (2, 20, 260)]])
def test_wave_ring_runs_the_plans(layers, n, h, mode):
    """The wavefront's ring under the plan of each shape (two teams on 3
    slots with the count at 2x512 HIGH, on 8 without it at DEFAULT, one
    team on 2 slots at 3x448 and 4x352 HIGH) ends under several schedules
    over F = 3 and F = L - 1 (its phases of 1 to min(L, F + 1) items a
    chunk), every copy in its slot when it is read and never over a slot
    still being read."""
    plan = K.lstm_stack_plan(layers, n, h, wavefront=True, precision=mode)
    n_chunks, stages = -(-n // 16), plan.stage_rows // 16
    for steps in {3, layers - 1}:
        for order in ring_schedules(layers + n + h):
            assert ring_run(layers, n_chunks, stages, plan.teams, steps=steps, order=order,
                            wavefront=True)


@pytest.mark.parametrize("stages", range(1, K.MAX_SLOTS + 1))
@pytest.mark.parametrize("layers", [2, 3, 4])
def test_wave_count_rule_matches_the_ring_model(layers, stages):
    """The count of the items issued, kept per phase where ``count_needed``
    says (the kernel's rule, at the phase's items a chunk: 1 to L over F =
    3 steps): on the plan's teams the wavefront's ring ends clean under
    every schedule for 1 to 9 chunks; with the count dropped at the phases
    of one item count a chunk alone, a schedule fails exactly where the rule
    keeps it there, and none elsewhere."""
    for n_chunks in range(1, 10):
        for ipc, (kept, fails) in count_rule_check(layers, n_chunks, stages,
                                                   wavefront=True).items():
            assert fails == kept, (n_chunks, ipc, kept, fails)


@pytest.mark.parametrize("layers, n_chunks, stages, ipc", [(2, 4, 3, 1), (2, 4, 3, 2),
                                                           (3, 2, 5, 3), (4, 2, 6, 4),
                                                           (3, 4, 8, 3)])
def test_wave_ring_model_finds_the_fault_without_the_count(layers, n_chunks, stages, ipc):
    """A case for each item count a chunk (1 to 4) where the rule keeps the
    count: without it at those phases a full mbarrier two phases behind
    passes by parity. (3, 4, 8, 3): 3x448 at DEFAULT from N=49, eight slots
    under a phase's 12 items."""
    assert count_rule_check(layers, n_chunks, stages, wavefront=True)[ipc] == (True, True)


# ---------------------------------------------------------------------------
# The write-once data flow


def _product(parts, w, mode):
    """A product of an operand's bf16 parts with a weight's: ``hi@Wh`` at
    default, ``hi@Wh + lo@Wh + hi@Wl`` at high (dot3's order)."""
    out = P.mm_bf16(parts[0], w[0])
    if mode == "high":
        out = out + P.mm_bf16(parts[1], w[0]) + P.mm_bf16(parts[0], w[1])
    return out


def _wave_flow(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, mode, units=4):
    """The stack in the wavefront order with the data flow of the mode body:
    each layer's h0 and then its selected state after each step rounded
    once into bf16 parts (split_bf16: hi, and lo at high) through the
    exchange's two slots a layer, written as soon as it is made; phase p
    reads back layer l's state after p - l - 1 (its recurrent operand) and,
    from layer 1 on, layer l - 1's after p - l (its input, the rows scaled
    by the mask: the output h_new * mask), both from the slots of the
    kernel's schedule. The products go in the plain version's shape, the
    input beside the recurrent operand by [W_ih; W_hh] (the kernel takes the
    two halves in turn into the same sums), the cell in f32."""
    layers, (f, n), h = w_hh.shape[0], mask.shape, w_hh.shape[1]
    exchange = [StackExchange(layers, n, h, units, part.float().numpy())
                for part in P.bf16_parts(h0, mode)]

    def read(sl, k):
        return [torch.from_numpy(ex.read(sl, k)[:n, :h]).to(torch.bfloat16) for ex in exchange]

    w_cat = [torch.cat([w_ih_up[l - 1], w_hh[l]]) for l in range(1, layers)]
    hs, cs, outs = list(h0.unbind(0)), list(c0.unbind(0)), []
    for p, l_first, l_last in stack_phases(layers, f, wavefront=True):
        for l in range(l_first, l_last + 1):
            t = p - l
            m = mask[t][:, None]
            rec = read(t & 1, l)
            if l == 0:
                gates = x0_proj[t] + _product(rec, P.weight_parts(w_hh[0], mode), mode)
            else:
                inp = read((t + 1) & 1, l - 1)
                parts = [torch.cat([a * m.to(torch.bfloat16), b], dim=-1) for a, b in zip(inp, rec)]
                gates = _product(parts, P.weight_parts(w_cat[l - 1], mode), mode) + b_up[l - 1]
            i, f_, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f_) * cs[l] + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            hs[l] = torch.where(m > 0, h_new, hs[l])
            cs[l] = torch.where(m > 0, c_new, cs[l])
            for ex, part in zip(exchange, P.bf16_parts(hs[l], mode)):  # the selected state
                ex.write((t + 1) & 1, l, part.float().numpy())
            if l == layers - 1:
                outs.append(h_new * m)
    return torch.stack(outs), torch.stack(hs), torch.stack(cs)


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_plain_wavefront_is_the_write_once_data_flow(mode, layers):
    """``lstm_stack_wavefront_plain`` (and the wrapper on CPU tensors) at
    the mode equals the write-once data flow bit for bit; the 0-length row
    keeps its state bit for bit and has zero outputs; the flow lies within
    the tolerances that ``tests/test_torch_precision.py`` holds the plain
    version to: at HIGH within HIGH_TOL of ``_pallas_wavefront`` in
    interpret mode (both dot3 of the same bf16 splits, f32 sums in another
    order) and closer to it than the plain version at HIGHEST; at DEFAULT
    within DEFAULT_EMUL_TOL of a JAX scan with bf16 products and within
    BF16_TOL of the JAX wavefront at HIGHEST."""
    cells, x, mask, lengths, h0, c0 = _high_inputs(layers, seed=6)
    x0_proj, w_hh, w_up, b_up = K.stack_operands([_t_cell(c) for c in cells],
                                                  torch.from_numpy(x), mode)
    tm, th0, tc0 = _t(mask, h0, c0)
    args = (x0_proj, tm, w_hh, w_up, b_up, th0, tc0)
    flow = _wave_flow(*args, mode)
    for got in (K.lstm_stack_wavefront_plain(*args, mode),
                K.lstm_stack_wavefront_fused(*args, mode)):
        assert all(torch.equal(a, b) for a, b in zip(got, flow))
    for row in np.flatnonzero(lengths == 0):
        assert torch.equal(flow[1][:, row], th0[:, row])
        assert torch.equal(flow[2][:, row], tc0[:, row])
        assert (flow[0][:, row] == 0).all()
    if mode == "high":
        mc = jnp.asarray(mask)[:, :, None]
        zero = jnp.zeros_like(mc[:1])
        m_all = jnp.stack([jnp.concatenate([zero] * l + [mc] + [zero] * (layers - 1 - l))
                           for l in range(layers)], axis=1)
        w_cat = jnp.stack([jnp.concatenate([jnp.asarray(w_up[l - 1].numpy()),
                                            jnp.asarray(w_hh[l].numpy())])
                           for l in range(1, layers)])
        want = JK._pallas_wavefront(jnp.asarray(x0_proj.numpy()), m_all,
                                    jnp.asarray(w_hh[0].numpy()), w_cat,
                                    jnp.asarray(b_up.numpy())[:, None], jnp.asarray(h0),
                                    jnp.asarray(c0), num_layers=layers, hidden=w_hh.shape[1],
                                    interpret=True, precision=lax.Precision.HIGH)[:3]
        _assert_close(flow, want, HIGH_TOL)
        assert _max_diff(flow, want) < _max_diff(K.lstm_stack_wavefront_plain(*args, "highest"),
                                                 want)
    else:
        _assert_close(flow, _stack_scan_bf16(cells, x, mask, h0, c0), DEFAULT_EMUL_TOL)
        j_out, (j_h, j_c) = JK.lstm_stack_pallas_wavefront(
            cells, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0), jnp.asarray(c0),
            precision=lax.Precision.HIGHEST, interpret=True)
        _assert_close(flow, (j_out, j_h, j_c), BF16_TOL)
