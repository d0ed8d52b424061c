"""Bulk replay: every recorded session is a stream of a
``MultiStreamPredictor``, and each step serves the next chunk of all of them,
pushed as soon as the previous step returned (a closed loop).

Traffic keys: ``streams``, ``chunk`` (frames), ``session_frames`` (length
of each recording in the pool, looped), ``warmup`` (steps of a throwaway
predictor), ``trace_seconds``, ``sample_streams`` and ``sample_share``:
the streams checked, and the share of their chunks kept for the check,
drawn from the seed (a stream's first and last chunk always).
"""

from __future__ import annotations

import time
from typing import Dict

from benchmark import assets as A
from benchmark import flops
from benchmark.drivers import common as D
from benchmark.drivers import serving as S
from benchmark.trace import Tracer


def setup(run) -> Dict:
    device = D.device_of(run)
    inputs = D.Inputs(run, device)
    tr = run.traffic
    n = tr["streams"]
    rng = A.rng_of(run.seed, D.SESSIONS)
    sessions = S.Sessions(inputs, rng, n, n, tr["session_frames"], tr["chunk"])
    run.phase("inputs and sessions")
    model = S.program_model(run, inputs)
    run.phase("model")
    D.reset_peak(device)
    warm = S.predictor(model, sessions)
    for k in range(tr["warmup"]):
        for i in range(n):
            warm.push(i, *sessions.chunk_of(i, k))
        warm.step()
    run.tracer = Tracer(run.trace, tr["trace_seconds"])
    run.tracer.warm()
    D.sync(device)
    run.phase("warm-up")
    run.shapes["lstm_stack"] = {"F": tr["chunk"], "N": n, "H": run.flags["m_rnn_hidden_size"],
                                "L": run.flags["m_rnn_num_layers"]}
    return {"device": device, "inputs": inputs, "sessions": sessions, "model": model,
            "pred": S.predictor(model, sessions),
            "checked": S.sample(A.rng_of(run.seed, D.SAMPLE), n, tr["sample_streams"])}


def window(run, state) -> None:
    tr, sessions, pred = run.traffic, state["sessions"], state["pred"]
    n = sessions.n
    keep_rng = A.rng_of(run.seed, D.SAMPLE + 1)
    checked = state["checked"]
    kept = {i: {} for i in checked}
    last = {}
    k, missing, tracer = 0, 0, run.tracer
    t0 = time.perf_counter()
    tracer.begin()
    while True:
        host_part = tracer.part == 1
        for i in range(n):
            pred.push(i, *sessions.chunk_of(i, k))
        a = time.time_ns()
        outs = pred.step()
        run.span("step", a, time.time_ns(), timed=not host_part)
        missing += n - len(outs)
        keep = k == 0 or keep_rng.random() < tr["sample_share"]
        for i in checked:
            if i in outs:
                if keep:
                    kept[i][k] = outs[i]
                else:
                    last[i] = (k, outs[i])
        k += 1
        elapsed = time.perf_counter() - t0
        tracer.after_call(elapsed, k)
        if elapsed >= run.seconds:
            break
    t1 = time.perf_counter()
    tracer.end(k)
    for i, (kk, out) in last.items():
        kept[i][kk] = out
    state.update(kept=kept, served={i: k for i in checked})
    run.attempted, run.failed = k * n, missing
    run.e2e["infer_frames_per_s"] = (k * n - missing) * tr["chunk"] / (t1 - t0)
    run.counters.update(steps=k, streams_served=k * n - missing)


def check(run, state) -> None:
    state["model"] = state["pred"] = None
    D.release(state["device"])
    state["ref"] = S.reference_outputs(run, state["inputs"], state["sessions"], state["kept"],
                                       state["served"])
    for name, value in S.gaps(state["kept"], state["ref"]).items():
        run.compare(name, value)
    if run.trace:
        tr = run.traffic
        run.flops_per_call = flops.eval_forward(state["inputs"], run.flags, tr["streams"],
                                                tr["chunk"])


def control(run, state) -> Dict[str, float]:
    """The control: the reference at TF32 in the program's place."""
    args = (run, state["inputs"], state["sessions"], state["kept"], state["served"])
    return S.gaps(S.reference_outputs(*args, tf32=True), state["ref"])
