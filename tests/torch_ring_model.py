"""CPU models of what the LSTM kernels' HIGH and DEFAULT bodies share
(``csrc/lstm_common.cuh``), for the tests of the bidirectional layer
(``tests/test_torch_bidi_modes.py``), the stack in its two orders
(``tests/test_torch_stack_modes.py``, ``tests/test_torch_wave_modes.py``)
and the training forward sweep
(``tests/test_torch_fwd_modes.py``):

* the exchange of a state's bf16 form in 16x16 k-step tiles
  (``tile_offset``, ``exchange_index``, :class:`Exchange`; the stack
  kernel's two slots a layer, :class:`StackExchange`);
* the ring of bulk copies on full and empty mbarriers, one actor a warp,
  copies landing in any order, in the stack kernel's two orders
  (:func:`ring_run`), and where a ring keeps the count of its items issued
  (:func:`count_needed`).
"""

import numpy as np


def kp16(h):
    """H padded to whole 16-column k-steps (``kpad16``)."""
    return -(-h // 16) * 16


def tile_offset(r, c):
    """``lstm_common.cuh`` ``tile_offset``: row r at 16 r, its 8-column half
    c // 8 swizzled by r // 4 % 2."""
    return r * 16 + ((c // 8) ^ (r // 4 % 2)) * 8 + c % 8


def exchange_index(n, j, ks):
    """``lstm_common.cuh`` ``exchange_index``: (16-row chunk, k-step) tiles."""
    return ((n // 16) * ks + j // 16) * 256 + tile_offset(n % 16, j % 16)


class Exchange:
    """One slot of one state of an exchange, one part (the bidirectional
    layer: one direction's; the forward sweep: h_all[t]'s): the launch's
    prologue writes the zeros past N and past H, each block writes its U
    columns of every row (each element once), and every block reads a
    chunk's k-step tiles as ldmatrix does."""

    def __init__(self, n, h, units):
        self.n, self.h, self.units = n, h, units
        self.ks, self.chunks = kp16(h) // 16, -(-n // 16)
        self.x = np.full(self.chunks * self.ks * 256, np.nan, np.float32)
        self.writes = np.zeros(self.x.shape, np.int64)
        for n_ in range(n, self.chunks * 16):
            self._put(n_, range(kp16(h)), 0.0)
        for n_ in range(n):
            self._put(n_, range(h, kp16(h)), 0.0)

    def _put(self, n, cols, values):
        idx = [exchange_index(n, j, self.ks) for j in cols]
        self.x[idx] = values
        np.add.at(self.writes, idx, 1)

    def write(self, state):
        """The owners' writes: block b's columns b U .. b U + U - 1."""
        for j0 in range(0, self.h, self.units):
            for n_ in range(self.n):
                self._put(n_, range(j0, j0 + self.units), state[n_, j0:j0 + self.units])

    def read(self):
        """The (chunks x 16, Kp) matrix the blocks' ldmatrix reads assemble:
        lane l of k-step ks reads row l % 16's 8 elements at tile_offset(l %
        16, 8 (l // 16))."""
        out = np.zeros((self.chunks * 16, kp16(self.h)), np.float32)
        for c in range(self.chunks):
            for ks in range(self.ks):
                tile = self.x[(c * self.ks + ks) * 256:][:256]
                for lane in range(32):
                    r, half = lane % 16, lane // 16
                    at = tile_offset(r, 8 * half)
                    out[c * 16 + r, 16 * ks + 8 * half:][:8] = tile[at:at + 8]
        return out


class StackExchange:
    """One part of the exchange of an L-layer stack, as ``ring_body`` fills
    it: (slot 2, layer L) regions of 16-row chunks of KS k-step tiles. The
    launch's prologue writes the zeros past N and past H of every region
    and each layer's h0 into its slot 0; the owners (block b: columns b U ..
    b U + U - 1) write each state; every block reads a chunk's k-step tiles
    as ldmatrix does."""

    def __init__(self, layers, n, h, units, h0):
        self.layers, self.n, self.h, self.units = layers, n, h, units
        self.ks, self.chunks = kp16(h) // 16, -(-n // 16)
        self.region = self.chunks * self.ks * 256
        self.x = np.full(2 * layers * self.region, np.nan, np.float32)
        self.writes = np.zeros(self.x.shape, np.int64)
        for sl in range(2):
            for l in range(layers):
                for n_ in range(n, self.chunks * 16):
                    self._put(sl, l, n_, range(kp16(h)), 0.0)
                for n_ in range(n):
                    self._put(sl, l, n_, range(h, kp16(h)), 0.0)
        for l in range(layers):
            self.write(0, l, h0[l])

    def _index(self, sl, l, n, j):
        return (sl * self.layers + l) * self.region + exchange_index(n, j, self.ks)

    def _put(self, sl, l, n, cols, values):
        idx = [self._index(sl, l, n, j) for j in cols]
        self.x[idx] = values
        np.add.at(self.writes, idx, 1)

    def write(self, sl, l, state):
        for j0 in range(0, self.h, self.units):
            for n_ in range(self.n):
                self._put(sl, l, n_, range(j0, j0 + self.units), state[n_, j0:j0 + self.units])

    def read(self, sl, l):
        """The (chunks x 16, Kp) matrix of slot sl of layer l that the
        blocks' ldmatrix reads assemble."""
        out = np.zeros((self.chunks * 16, kp16(self.h)), np.float32)
        base = (sl * self.layers + l) * self.region
        for c in range(self.chunks):
            for ks in range(self.ks):
                tile = self.x[base + (c * self.ks + ks) * 256:][:256]
                for lane in range(32):
                    r, half = lane % 16, lane // 16
                    at = tile_offset(r, 8 * half)
                    out[c * 16 + r, 16 * ks + 8 * half:][:8] = tile[at:at + 8]
        return out


# ---------------------------------------------------------------------------
# The ring's copies and waits


class MBarrier:
    """An mbarrier: ``count`` arrivals complete a phase; ``try_wait.parity
    p`` succeeds once the phase of parity p has completed, i.e. while the
    completed count's parity differs from p."""

    def __init__(self, count):
        self.count, self.pending, self.done = count, 0, 0

    def arrive(self):
        self.pending += 1
        if self.pending == self.count:
            self.pending, self.done = 0, self.done + 1

    def ready(self, parity):
        return (self.done & 1) != parity


class Sync:
    """bar.sync / grid.sync: ``count`` actors meet."""

    def __init__(self, count):
        self.count, self.pending, self.generation = count, 0, 0

    def meet(self):
        gen = self.generation
        self.pending += 1
        if self.pending == self.count:
            self.pending, self.generation = 0, gen + 1
        yield lambda: self.generation != gen


def stack_phases(layers, steps, wavefront=False):
    """The phases of the stack kernel (``phase_at`` in ``csrc/lstm_stack.cu``)
    over ``steps`` steps, as (wave, l_first, l_last): the stack order runs
    phase (t, l) as (t + l, l, l), the wavefront order phase p every layer l
    with 0 <= p - l < steps."""
    if wavefront:
        return [(p, max(0, p - steps + 1), min(layers - 1, p))
                for p in range(steps + layers - 1)]
    return [(t + l, l, l) for t in range(steps) for l in range(layers)]


def ring_run(layers, n_chunks, stages, teams, units=4, steps=3, order=None, wait_issued=True,
             wavefront=False):
    """``ring_phases`` (``csrc/lstm_stack.cu``) for one block, one actor a
    warp (warp 0 holds thread 0, which issues the copies), in the stack
    order or (``wavefront``) the wavefront order; at one layer (one item a
    chunk) the ring of ``mma_steps`` (``csrc/lstm_bidi.cu``) and of
    ``fwd_steps`` (``csrc/lstm_train.cu``). A phase's chunk holds one item
    per staged state (layers max(0, l_first - 1) ... l_last); a warp waits
    for an item at its first use and frees its slot after its last (in the
    wavefront order layer k's state is multiplied by W_hh[k], then as layer
    k + 1's input). It runs under the schedule ``order``: a numpy
    RandomState picks among the actors that can go on, the copies in flight
    landing in any order; None and "late" take the lowest warp that can go
    on, and land a copy only where none can, the oldest (None) or the newest
    ("late") first. Each item's slot holds what the item names (layer, step
    of its state, chunk), checked at each use when it starts and ends, so a
    read of a copy not yet landed, or a copy landing over a slot still being
    read, fails; so does a full mbarrier passed by parity more than one
    phase early. With two teams (and no reuse) a phase keeps the count of
    the items issued where ``wait_issued(n_chunks, stages, items a chunk)``
    says (True: :func:`count_needed`, the kernel's rule; False: in no
    phase): there every warp but thread 0's waits until its item is issued
    (thread 0 publishes the count after each copy).
    Returns True where every warp ends, False on a deadlock."""
    keeps = count_needed if wait_issued is True else wait_issued or (lambda *_: False)
    warps, stacked = 8, units == 4
    team_warps = warps // teams
    reuse = stacked and layers == 2 and stages >= 2 * n_chunks and not wavefront
    full = [MBarrier(1) for _ in range(stages)]
    empty = [MBarrier(team_warps) for _ in range(stages)]
    held = [None] * stages
    in_flight = []  # (slot, what the copy holds)
    count = [0]  # the items issued in the launch
    team_syncs = [Sync(team_warps) for _ in range(teams)]
    grid = Sync(warps)
    both = teams > 1 and not reuse

    def warp(w):
        team, thread0 = w // team_warps, w == 0
        base = 0
        for wave, l_first, l_last in stack_phases(layers, steps, wavefront):
            lo = max(0, l_first - 1)
            ipc = l_last - lo + 1
            n_items = 0 if reuse and l_first == 0 and wave > 0 else n_chunks * ipc
            counted = both and keeps(n_chunks, stages, ipc)

            def slot_use(i):
                if not reuse:
                    return (base + i) % stages, (base + i) // stages
                if l_first == 0:
                    return 2 * i, wave
                return i, wave - l_first + (i % 2 == 0)

            def names(i):  # (layer, step of its state, chunk)
                k = lo + i % ipc
                return k, wave - k - 1, i // ipc

            def issue(i):
                slot, use = slot_use(i)
                if not reuse and use > 0:
                    yield lambda: empty[slot].ready((use - 1) & 1)
                    assert empty[slot].done == use
                in_flight.append((slot, names(i)))
                if counted:
                    count[0] = base + i + 1

            issued = [0]

            def issue_to(end):
                for k in range(issued[0], end):
                    yield from issue(k)
                issued[0] = max(issued[0], end)

            if thread0:
                yield from issue_to(min(stages, n_items))
            for c in range(team, n_chunks, teams):
                for l in range(l_first, l_last + 1):
                    uses = []  # (item, its first use, its last)
                    if stacked and l > 0:  # the input product
                        uses.append((c * ipc + l - 1 - lo, not wavefront or l == l_first, True))
                    uses.append((c * ipc + l - lo, True, not wavefront or l == l_last))
                    for i, first, last in uses:
                        slot, use = slot_use(i)
                        want = (0, wave - 1, c) if n_items == 0 else names(i)
                        if first:
                            if counted and w > 0:
                                yield lambda: count[0] > base + i
                            yield lambda: full[slot].ready(use & 1)
                            assert full[slot].done == use + 1
                        assert held[slot] == want
                        yield lambda: True  # the products
                        assert held[slot] == want
                        if last:
                            empty[slot].arrive()
                            if thread0:
                                yield from issue_to(min(n_items, i + stages + 1))
                    if teams > 1:
                        yield from team_syncs[team].meet()
                    yield from team_syncs[team].meet()
            yield from grid.meet()
            base += n_chunks * ipc

    actors = [warp(w) for w in range(warps)]
    waits = [lambda: True] * warps
    while actors or in_flight:
        ready = [k for k, wait in enumerate(waits) if wait()] + ([len(actors)] if in_flight else [])
        if not ready:
            return False
        pick = isinstance(order, np.random.RandomState)
        k = ready[order.randint(len(ready))] if pick else ready[0]
        if k == len(actors):  # a copy lands
            slot, what = in_flight.pop(order.randint(len(in_flight)) if pick else
                                       0 if order is None else -1)
            held[slot] = what
            full[slot].arrive()
            continue
        try:
            waits[k] = next(actors[k])
        except StopIteration:
            del actors[k], waits[k]
    return True


def count_needed(n_chunks, stages, items_per_chunk=1):
    """Whether a phase of ``n_chunks`` chunks of ``items_per_chunk`` items,
    the chunks taken in turns by two teams, keeps the count of the items
    issued on a ring of ``stages`` slots (``count_needed`` in
    ``csrc/lstm_stack.cu``; at one item a chunk ``count`` in
    ``csrc/lstm_bidi.cu`` ``mma_steps`` and ``csrc/lstm_train.cu``
    ``fwd_steps``): only where some item i >= stages finds its slot's item
    before, i - stages, in a chunk of the other team, so that it may still
    be in flight when a warp waits for item i (a slot's other items before
    are the same team's, read before, or an earlier phase's, landed before
    its grid barrier). At one item a chunk that is an odd slot count under
    the phase's chunks; at two, a slot count odd or 2 mod 4 under the
    phase's items (with edge cases at the last chunk)."""
    ipc = items_per_chunk
    return any((i // ipc - (i - stages) // ipc) % 2
               for i in range(stages, min(n_chunks * ipc, stages + ipc)))


def count_rule_check(layers, n_chunks, stages, wavefront=False, units=4, steps=3):
    """The count rule against :func:`ring_run` on the plan's teams (two
    where a phase has two chunks or more and the ring more slots than a
    chunk has items, as ``lstm_stack_plan`` gives them): with the count kept
    where :func:`count_needed` says, every schedule of
    :func:`ring_schedules` must end clean (else AssertionError). Returns,
    for each item count a chunk that the run's phases have, (the rule keeps
    the count there, a schedule fails with the count dropped at those phases
    alone); at one team (nothing to count) an empty dict."""
    planes = layers if wavefront else min(layers, 2)
    teams = 2 if n_chunks > 1 and stages > planes else 1
    run = lambda order, keeps=True: ends_clean(layers, n_chunks, stages, teams, units, steps,
                                               order, keeps, wavefront)
    orders = lambda: ring_schedules(n_chunks * 10 + stages)
    assert all(run(order) for order in orders()), (layers, n_chunks, stages, wavefront)
    reuse = not wavefront and units == 4 and layers == 2 and stages >= 2 * n_chunks
    if teams == 1 or reuse:
        return {}
    out = {}
    for _, l_first, l_last in stack_phases(layers, steps, wavefront):
        ipc = l_last - max(0, l_first - 1) + 1
        if ipc in out:
            continue
        drop = lambda nc, st, k, ipc=ipc: k != ipc and count_needed(nc, st, k)
        out[ipc] = (count_needed(n_chunks, stages, ipc),
                    not all(run(order, drop) for order in orders()))
    return out


def ring_schedules(seed):
    return [None, "late"] + [np.random.RandomState(seed + s) for s in range(3)]


def ends_clean(*args, **kwargs):
    """ring_run, a read too early counted as a failure like a deadlock."""
    try:
        return ring_run(*args, **kwargs)
    except AssertionError:
        return False
