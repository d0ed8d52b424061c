"""CPU models of what the LSTM kernels' HIGH and DEFAULT bodies share
(``csrc/lstm_common.cuh``), for the tests of the bidirectional layer
(``tests/test_torch_bidi_modes.py``), the stack
(``tests/test_torch_stack_modes.py``) and the training forward sweep
(``tests/test_torch_fwd_modes.py``):

* the exchange of a state's bf16 form in 16x16 k-step tiles
  (``tile_offset``, ``exchange_index``, :class:`Exchange`);
* the ring of bulk copies on full and empty mbarriers, one actor a warp,
  copies landing in any order (:func:`ring_run`), and where the ring of one
  item a chunk keeps the count of its chunks issued (:func:`count_needed`).
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


def ring_run(layers, n_chunks, stages, teams, units=4, steps=3, order=None, wait_issued=True):
    """``ring_phases`` (``csrc/lstm_stack.cu``) for one block, one actor a
    warp (warp 0 holds thread 0, which issues the copies); at one layer (one
    item a chunk) the ring of ``mma_steps`` (``csrc/lstm_bidi.cu``) and of
    ``fwd_steps`` (``csrc/lstm_train.cu``). It runs under the
    schedule ``order``: a numpy RandomState picks among the actors that can
    go on, the copies in flight landing in any order; None and "late" take
    the lowest warp that can go on, and land a copy only where none can, the
    oldest (None) or the newest ("late") first. Each item's
    slot holds what the item names (layer, step of its state, chunk),
    checked when a warp's product starts and again when it ends, so a read
    of a copy not yet landed, or a copy landing over a slot still being
    read, fails; so does a full mbarrier passed by parity more than one
    phase early. With two teams (and no reuse), as the kernel does,
    ``wait_issued`` has every warp but thread 0's wait until its item is
    issued (thread 0 publishes the count after each copy).
    Returns True where every warp ends, False on a deadlock."""
    warps, stacked = 8, units == 4
    team_warps = warps // teams
    reuse = stacked and layers == 2 and stages >= 2 * n_chunks
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
        for ph in range(steps * layers):
            t, l = divmod(ph, layers)
            ipc = 2 if stacked and l > 0 else 1
            n_items = 0 if reuse and l == 0 and t > 0 else n_chunks * ipc
            base = t * n_chunks * (2 * layers - 1) + (n_chunks * (2 * l - 1) if l else 0)

            def slot_use(i):
                if not reuse:
                    return (base + i) % stages, (base + i) // stages
                if l == 0:
                    return 2 * i, t
                return i, t + (i % 2 == 0)

            def names(i):  # (layer, step of its state, chunk); reuse at (t > 0, 0): slot 2c
                if ipc == 2 and i % 2 == 0:
                    return l - 1, t, i // 2
                return l, t - 1, i // ipc

            def issue(i):
                slot, use = slot_use(i)
                if not reuse and use > 0:
                    yield lambda: empty[slot].ready((use - 1) & 1)
                    assert empty[slot].done == use
                in_flight.append((slot, names(i)))
                count[0] = base + i + 1

            issued = [0]

            def issue_to(end):
                for k in range(issued[0], end):
                    yield from issue(k)
                issued[0] = max(issued[0], end)

            if thread0:
                yield from issue_to(min(stages, n_items))
            for c in range(team, n_chunks, teams):
                for i in ([2 * c, 2 * c + 1] if ipc == 2 else [c]):
                    slot, use = slot_use(i)
                    want = (0, t - 1, c) if n_items == 0 else names(i)
                    if both and wait_issued and w > 0:
                        yield lambda: count[0] > base + i
                    yield lambda: full[slot].ready(use & 1)
                    assert full[slot].done == use + 1 and held[slot] == want
                    yield lambda: True  # the products
                    assert held[slot] == want
                    empty[slot].arrive()
                    if thread0:
                        yield from issue_to(min(n_items, i + stages + 1))
                if teams > 1:
                    yield from team_syncs[team].meet()
                yield from team_syncs[team].meet()
            yield from grid.meet()

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


def count_needed(n_chunks, stages):
    """Whether the ring of one item a chunk with two teams keeps the count
    of the chunks issued (``count`` in ``csrc/lstm_bidi.cu`` ``mma_steps``
    and ``csrc/lstm_train.cu`` ``fwd_steps``): only where a slot's
    consecutive chunks of a step go to different teams, an odd slot count
    under the step's chunks."""
    return stages % 2 == 1 and stages < n_chunks


def ring_schedules(seed):
    return [None, "late"] + [np.random.RandomState(seed + s) for s in range(3)]


def ends_clean(*args, **kwargs):
    """ring_run, a read too early counted as a failure like a deadlock."""
    try:
        return ring_run(*args, **kwargs)
    except AssertionError:
        return False
