"""Training traffic: ``Trainer.train_step`` back to back on host batches of
pose windows, a pool drawn from the seed and cycled through the window.

Traffic keys: ``batch``, ``window`` (frames), ``pool`` (host batches),
``warmup`` (steps after the three checked ones), ``trace_seconds``.

Set-up builds one ``Trainer`` with the benchmark's weights and drives it
through its first three steps with the window's own call, on three
different batches; the same object then runs the window. After the window
the reference follows those three steps from the same weights, batches and
seed, and the run compares each step's loss, every leaf's first gradient
(read from Adam's first moment after step 1) and every leaf's change over
the three steps, each as a gap of norms (``compare``).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from benchmark import assets as A
from benchmark import flops
from benchmark.drivers import common as D
from benchmark.reference import common as RC
from benchmark.trace import Tracer

CHECKED_STEPS = 3
SMALL_GRAD = 1e-3   # a leaf whose reference gradient is under this share of the median leaf's


def setup(run) -> Dict:
    from empose_tpu_torch.config import Configuration
    from empose_tpu_torch.train.loop import Trainer

    device = D.device_of(run)
    inputs = D.Inputs(run, device)
    tr = run.traffic
    rng = A.rng_of(run.seed, D.DATA)
    pool = [A.pose_windows(rng, tr["batch"], tr["window"]) for _ in range(tr["pool"])]
    run.phase("inputs")
    trainer = Trainer(Configuration.from_dict(dict(run.flags, seed=run.seed)), seed=run.seed,
                      device=run.device)
    trainer.model.load_state_dict(inputs.weights, strict=True)
    run.phase("trainer")
    D.reset_peak(device)
    first = program_steps(trainer, pool)
    run.phase("checked steps")
    for i in range(tr["warmup"]):
        trainer.train_step(pool[(CHECKED_STEPS + i) % len(pool)])
    run.tracer = Tracer(run.trace, tr["trace_seconds"])
    run.tracer.warm()
    D.sync(device)
    run.phase("warm-up")
    hidden = run.flags["m_rnn_hidden_size" if run.flags["m_type"] in ("lgd", "ief") else "m_hidden_size"]
    run.shapes["lstm_train"] = {"F": tr["window"], "N": tr["batch"], "H": hidden}
    return {"device": device, "inputs": inputs, "pool": pool, "trainer": trainer, "first": first,
            "next": CHECKED_STEPS + tr["warmup"]}


def program_steps(trainer, pool) -> Dict:
    """The program's first steps: each loss, each leaf's first gradient as
    Adam holds it, each leaf's change over the steps (norms by name)."""
    start = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    losses, grad = [], {}
    b1 = RC.ADAM_BETAS[0]
    for i in range(CHECKED_STEPS):
        vals = trainer.train_step(pool[i])
        losses.append(float(vals["total_loss"]))
        if i == 0:
            grad = {k: float(trainer.opt.state[p]["exp_avg"].norm() / (1 - b1))
                    for k, p in trainer.model.named_parameters() if p in trainer.opt.state}
    change = {k: float((p.detach() - start[k]).norm()) for k, p in trainer.model.named_parameters()}
    return {"loss": losses, "grad": grad, "change": change}


def window(run, state) -> None:
    trainer, pool, device = state["trainer"], state["pool"], state["device"]
    tr, tracer = run.traffic, run.tracer
    i, steps = state["next"], 0
    D.sync(device)
    t0 = time.perf_counter()
    tracer.begin()
    while True:
        host_part = tracer.part == 1
        a = time.time_ns()
        trainer.train_step(pool[i % len(pool)])
        i += 1
        steps += 1
        if run.trace:   # each call synchronized, its span read; not the host part's
            D.sync(device)
            run.span("train_step", a, time.time_ns(), timed=not host_part)
        elapsed = time.perf_counter() - t0
        tracer.after_call(elapsed, steps)
        if elapsed >= run.seconds:
            break
    D.sync(device)
    t1 = time.perf_counter()
    tracer.end(steps)
    run.attempted = steps
    run.e2e["train_frames_per_s"] = steps * tr["batch"] * tr["window"] / (t1 - t0)


def reference_steps(run, state, tf32: bool) -> Dict:
    """The reference's first steps from the run's weights, batches and seed."""
    inputs, device = state["inputs"], state["device"]
    D.reference_precision(tf32)
    p = {k: v.clone() for k, v in inputs.weights.items()}
    names = inputs.params()
    adam = {"t": 0, "m": {}, "v": {}}
    gen = torch.Generator(device=device).manual_seed(run.seed)
    body, bank = inputs.body(), inputs.bank()
    losses, grad = [], {}
    for i in range(CHECKED_STEPS):
        host = state["pool"][i]
        batch = {"poses": torch.as_tensor(host["poses"], device=device),
                 "shapes": torch.as_tensor(host["shapes"], device=device),
                 "seq_lengths": torch.as_tensor(host["seq_lengths"], device=device).long()}
        loss, grads = RC.train_step(inputs.mod, p, names, adam, body, bank, batch, run.flags, gen)
        losses.append(loss)
        if i == 0:
            grad = {k: float(g.norm()) for k, g in grads.items()}
    change = {k: float((p[k] - inputs.weights[k]).norm()) for k in names}
    D.reference_precision(False)
    return {"loss": losses, "grad": grad, "change": change}


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a train cell can compare: each step's relative gap of
    the loss; the largest gap of the leaves' first-gradient norms and of
    their change norms, each against the larger of the leaf's reference
    norm and the median leaf's; and the median leaf's relative change gap.
    Leaves whose reference gradient is under SMALL_GRAD of the median
    leaf's move by round-off alone and are left out of the change."""
    out = {f"loss_gap_{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(got["loss"], ref["loss"]))}
    names = sorted(ref["grad"])
    med_g = statistics.median(ref["grad"][k] for k in names)
    grad = max(abs(got["grad"].get(k, 0.0) - ref["grad"][k]) / max(ref["grad"][k], med_g)
               for k in names)
    moved = [k for k in names if ref["grad"][k] >= SMALL_GRAD * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change = max(abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                 for k in moved)
    median = statistics.median(abs(got["change"][k] - ref["change"][k]) / ref["change"][k]
                               for k in moved)
    return dict(out, grad_norm_gap=grad, change_norm_gap=change, change_median_gap=median)


def check(run, state) -> None:
    state["trainer"] = None
    D.release(state["device"])
    state["ref"] = reference_steps(run, state, tf32=False)
    for name, value in gaps(state["first"], state["ref"]).items():
        run.compare(name, value)   # those the cell's limits name
    if run.trace:
        tr = run.traffic
        run.flops_per_call = flops.train_step(state["inputs"], run.flags, tr["batch"], tr["window"])


def control(run, state) -> Dict[str, float]:
    """The control: the reference at TF32 in the program's place."""
    return gaps(reference_steps(run, state, tf32=True), state["ref"])


def details(state) -> Dict:
    """The losses of both sides and the leaves the change comparison leaves
    out, by the rule on the reference gradient."""
    ref, got = state["ref"], state["first"]
    med = statistics.median(ref["grad"].values())
    moved = [k for k in ref["grad"] if ref["grad"][k] >= SMALL_GRAD * med]
    med_c = statistics.median(ref["change"][k] for k in moved)
    rel = {k: abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
           for k in moved}
    return {"program_loss": got["loss"], "reference_loss": ref["loss"],
            "left_out": sorted(set(ref["grad"]) - set(moved)),
            "change_worst_leaf": max(rel, key=rel.get), "readings": gaps(got, ref)}
