"""Live serving, an open loop: each of ``sessions`` independent sessions
delivers frames at ``fps`` and starts at a phase drawn from the seed; the
generator pushes a session's chunk when its last frame is due. One thread
alternates between the generator and ``MultiStreamPredictor.step``, which
serves every stream that has a chunk. A chunk's latency runs from its due
time to the moment its poses are on the host, so a stall counts against
every chunk queued behind it. Chunks due in the window are served to the
last, up to ``drain_seconds`` past its close; one never served fails.

The end-to-end number is the share of those chunks whose poses came within
one chunk period of the due time (a chunk later than that arrives after
the next one is due, so the session falls behind); one never served is
late. The p95 of the latency is a per-layer number: it follows the host's
speed, which drifts from run to run. A traced run's p95 counts only the
chunks due once the traced calls are over and no session holds more than
one chunk, so the profiler's stall is not in it.

Traffic keys: ``sessions``, ``chunk``, ``fps``, ``pool_sessions`` and
``session_frames`` (the recordings looped), ``warmup`` (steps of a
throwaway predictor), ``drain_seconds``, ``trace_seconds``,
``sample_sessions`` (sessions whose every chunk is checked).
"""

from __future__ import annotations

import sys
import time
from collections import deque
from typing import Dict

import numpy as np

from benchmark import assets as A
from benchmark.drivers import common as D
from benchmark.drivers import serving as S
from benchmark.trace import Tracer


def setup(run) -> Dict:
    device = D.device_of(run)
    inputs = D.Inputs(run, device)
    tr = run.traffic
    n = tr["sessions"]
    rng = A.rng_of(run.seed, D.SESSIONS)
    sessions = S.Sessions(inputs, rng, n, tr["pool_sessions"], tr["session_frames"], tr["chunk"])
    period = tr["chunk"] / tr["fps"]
    phase = rng.uniform(0.0, period, n)
    run.phase("inputs and sessions")
    model = S.program_model(run, inputs)
    run.phase("model")
    D.reset_peak(device)
    warm = S.predictor(model, sessions)
    for k in range(tr["warmup"]):
        for i in range(0, n, 1 + k % 2):   # every stream ready, then every other one
            warm.push(i, *sessions.chunk_of(i, k))
        warm.step()
    run.tracer = Tracer(run.trace, tr["trace_seconds"])
    run.tracer.warm()
    D.sync(device)
    run.phase("warm-up")
    run.shapes["lstm_stack"] = {"F": tr["chunk"], "N": n, "H": run.flags["m_rnn_hidden_size"],
                                "L": run.flags["m_rnn_num_layers"]}
    return {"device": device, "inputs": inputs, "sessions": sessions, "model": model,
            "pred": S.predictor(model, sessions), "period": period, "phase": phase,
            "checked": S.sample(A.rng_of(run.seed, D.SAMPLE), n, tr["sample_sessions"])}


def window(run, state) -> None:
    tr, sessions, pred = run.traffic, state["sessions"], state["pred"]
    n, period = sessions.n, state["period"]
    order = np.argsort(state["phase"], kind="stable")
    phase = state["phase"][order]
    checked = set(state["checked"])
    kept = {i: {} for i in checked}
    pending = [deque() for _ in range(n)]
    served_k = [0] * n
    lat, due_at, late = [], [], []
    rounds = int(np.ceil(run.seconds / period)) + 1
    t0 = time.perf_counter() + 0.01
    end = t0 + run.seconds
    due_of = lambda e: t0 + phase[e % n] + (e // n) * period
    total = sum(1 for e in range(rounds * n) if due_of(e) < end)
    e = steps = served = waiting = behind = 0      # behind: sessions holding 2+ chunks
    settled = None
    tracer = run.tracer
    tracer.begin()
    while True:
        now = time.perf_counter()
        while e < total and due_of(e) <= now:
            i, k = int(order[e % n]), e // n
            pred.push(i, *sessions.chunk_of(i, k))
            pending[i].append(due_of(e))
            behind += len(pending[i]) == 2
            waiting += 1
            late.append(now - due_of(e))
            e += 1
        if waiting:
            host_part = tracer.part == 1
            a = time.time_ns()
            outs = pred.step()
            done = time.perf_counter()
            run.span("step", a, time.time_ns(), timed=not host_part)
            steps += 1
            served += len(outs)
            for i, out in outs.items():
                behind -= len(pending[i]) == 2
                due_at.append(pending[i].popleft())
                lat.append(done - due_at[-1])
                waiting -= 1
                if i in checked:
                    kept[i][served_k[i]] = out
                served_k[i] += 1
            tracer.after_call(done - t0, steps)
            if settled is None and tracer.part == 2 and not behind:
                settled = done
        elif e >= total:
            break
        else:
            time.sleep(max(0.0, due_of(e) - time.perf_counter()))
        if time.perf_counter() > end + tr["drain_seconds"]:
            break
    stop = time.perf_counter()
    tracer.end(steps)
    for q in pending:                                   # never served: waited to the end
        due_at += q
        lat += [stop - d for d in q]
    lat, due_at = np.array(lat), np.array(due_at)
    state.update(kept=kept, served={i: served_k[i] for i in checked})
    run.attempted, run.failed = total, waiting
    run.e2e["serve_on_time_pct"] = 100.0 * float(np.mean(lat <= period))
    quiet = lat[due_at >= settled] if settled is not None else lat[:0]
    run.counters.update(steps=steps, streams_served=served,
                        chunk_p50_ms=float(np.percentile(lat, 50)) * 1e3,
                        chunk_p95_ms=float(np.percentile(lat, 95)) * 1e3,
                        late_p95_ms=float(np.percentile(late, 95)) * 1e3, late_max_ms=max(late) * 1e3)
    if quiet.size:
        run.counters["chunk_p95_settled_ms"] = float(np.percentile(quiet, 95)) * 1e3
    print(f"generator: {total} chunks due, late p95 {run.counters['late_p95_ms']:.3f} ms, "
          f"max {run.counters['late_max_ms']:.3f} ms; {steps} steps, "
          f"{served / max(steps, 1):.1f} streams a step, chunk p50 "
          f"{run.counters['chunk_p50_ms']:.3f} ms, p95 {run.counters['chunk_p95_ms']:.3f} ms "
          f"({quiet.size} settled: {run.counters.get('chunk_p95_settled_ms', float('nan')):.3f} ms), "
          f"on time {run.e2e['serve_on_time_pct']:.4f}%, {waiting} never served", file=sys.stderr)


def check(run, state) -> None:
    state["model"] = state["pred"] = None
    D.release(state["device"])
    state["ref"] = S.reference_outputs(run, state["inputs"], state["sessions"], state["kept"],
                                       state["served"])
    for name, value in S.gaps(state["kept"], state["ref"]).items():
        run.compare(name, value)


def control(run, state) -> Dict[str, float]:
    """The control: the reference at TF32 in the program's place."""
    args = (run, state["inputs"], state["sessions"], state["kept"], state["served"])
    return S.gaps(S.reference_outputs(*args, tf32=True), state["ref"])
