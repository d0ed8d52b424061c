"""The profilers' shared helpers (``empose_tpu_torch/tools/profile_common.py``)
against their JAX counterparts in ``__graft_entry__.py`` and ``bench.py``,
run unedited.

The offset bank, the batches and the window: arrays bit for bit (the same
numpy draws). The configs: every field equal. One ``make_train_step`` step
of the tiny LGD-RNN against the JAX ``make_train_step`` on the same
synthesized batch (offset noise off and a one-subject bank, so no draw
differs; dropout 0): the loss rtol 1e-5 and every gradient within 1e-4 x (1
+ its largest JAX entry), the bars of the train-step tests. The JAX sensor
runs its row-major FK (``use_lanes = False``, the ``EMPOSE_FK_LANES=0``
path), the port's: its lane-major FK moves the gradients from its own
row-major ones by up to 1.35e-4 of (1 + the largest), as the n*f-scaled
gradient input amplifies float32 rounding (the port read 1.64e-4 against
the lanes). Adam's first update moves an entry by about lr x sign(gradient):
every updated parameter whose JAX gradient exceeds the gradient tolerance
is held at 1e-4 x (1 + its largest JAX entry), the others at most one sign
flip (2 lr) beyond it, and under 1% of the entries flip. Then the FLOP
count's two parts and the timing guard, on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as GE
import bench as B
from empose_tpu.data import transforms as JT

from empose_tpu_torch.checkpoint.from_jax import grads_from_jax, state_dict_from_jax
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.tools import multihost_worker
from empose_tpu_torch.tools import profile_common as PC

torch.set_num_threads(1)


@pytest.mark.parametrize("n_subjects", [1, 2])
def test_in_memory_bank_matches_jax(n_subjects):
    got, want = PC.in_memory_bank(n_subjects), GE._in_memory_bank(n_subjects)
    for name in ("means", "chol", "r"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("which", ["tiny_batch", "make_window"])
def test_batches_match_jax(which):
    jax_fn = {"tiny_batch": GE._tiny_batch, "make_window": B.make_window}[which]
    got = getattr(PC, which)(np.random.RandomState(5), 3, 7)
    want = jax_fn(np.random.RandomState(5), 3, 7)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert multihost_worker.tiny_batch is PC.tiny_batch


@pytest.mark.parametrize("which", ["bench", "flagship", "flagship_tiny"])
def test_configs_match_jax(which):
    got, want = {"bench": (PC.bench_config, B.bench_config),
                 "flagship": (PC.flagship_config, GE._flagship_config),
                 "flagship_tiny": (lambda: PC.flagship_config(True),
                                   lambda: GE._flagship_config(True))}[which]
    got, want = vars(got()), vars(want())
    assert {k: got[k] for k in want} == want


def test_train_step_matches_jax():
    """One optimizer step of the tiny LGD-RNN (init RNN 1x32, iter MLPs 1x64,
    N=2) on a synthesized batch of 3 x 8 frames: loss, gradients, updated
    parameters against the JAX ``make_train_step``."""
    j_cfg = GE._flagship_config(tiny=True)
    j_cfg.offset_noise_level = -1
    j_model, j_sensor = GE._build_model(j_cfg)
    j_sensor.use_lanes = False  # the row-major FK, the port's (EMPOSE_FK_LANES=0)
    params, state = j_model.init(jax.random.PRNGKey(3))
    j_bank = GE._in_memory_bank(1)
    j_step, opt_init = GE.make_train_step(j_model, j_sensor, j_cfg, bank=j_bank)
    host = PC.tiny_batch(np.random.RandomState(4), n=3, f=8)
    batch = {k: jnp.asarray(v) for k, v in host.items()}
    key = jax.random.PRNGKey(11)

    # The gradients of the JAX step's loss (the step itself returns the update).
    pre = JT.make_preprocess_fn(j_sensor, j_bank, j_cfg, randomize_if_configured=True)
    k_pre, k_model = jax.random.split(key)
    synth = pre(batch, k_pre, mode="all")

    def loss_fn(p):
        out, _, _ = j_model.forward(p, state, synth, train=True, key=k_model)
        total, _ = j_model.compute_loss(synth, out)
        return total + j_model.reference_grad_extra_loss(out)

    j_grads = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
    new_params, new_state, _, j_vals = jax.jit(j_step)(params, state, opt_init(params), batch,
                                                       key)

    t_cfg = PC.flagship_config(tiny=True)
    t_cfg.offset_noise_level = -1
    model, sensor = PC.build_model(t_cfg)
    model.load_state_dict(state_dict_from_jax(params, state, t_cfg), strict=True)
    step, _ = PC.make_train_step(model, sensor, t_cfg, bank=PC.in_memory_bank(1))
    vals = step(to_device(host, "cpu"), torch.Generator().manual_seed(0))

    assert sorted(vals) == sorted(j_vals)
    for k, v in vals.items():
        np.testing.assert_allclose(float(v), float(j_vals[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want_grads = grads_from_jax(j_grads, t_cfg)
    want_params = state_dict_from_jax(jax.device_get(new_params), jax.device_get(new_state),
                                      t_cfg)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want_grads)
    flips = 0
    for k, p in named.items():
        g = want_grads[k].numpy()
        tol_g = 1e-4 * (1.0 + np.abs(g).max())
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=tol_g, err_msg=k)
        w = want_params[k].numpy()
        tol = 1e-4 * (1.0 + np.abs(w).max())
        diff = np.abs(p.detach().numpy() - w)
        settled = np.abs(g) > tol_g  # the gradient's sign holds within its tolerance
        assert diff[settled].max(initial=0.0) <= tol, k
        assert diff.max() <= 2 * t_cfg.lr + tol, k  # elsewhere: Adam's sign flip at most
        flips += int((diff > tol).sum())
    assert flips < 0.01 * sum(p.numel() for p in named.values())


def test_count_flops_adds_the_kernels_by_hand():
    """``FlopCounterMode`` counts the aten product; a launch counted by a
    kernel's counter during the call adds its hand count."""
    a, b = torch.randn(4, 5), torch.randn(5, 6)

    def fn(x, y):
        TK.FWD_LAUNCHES += 1  # stands for one launch of the forward sweep
        return x @ y

    count = PC.count_flops(fn, a, b, per_launch={"lstm_train_fwd": 1000.0})
    assert count.counted == 2 * 4 * 5 * 6 and count.by_hand == 1000.0
    assert count.total == 2 * 4 * 5 * 6 + 1000.0
    assert PC.count_flops(lambda x: x + 1, a) is None  # nothing to count
    per = PC.lstm_flops_per_launch(f=3, n=2, h=4, layers=2)
    assert per["lstm_train_fwd"] == per["lstm_train_bwd"] == 2 * 3 * 2 * 4 * 16
    assert per["lstm_stack"] == 3 * per["lstm_train_fwd"]


def test_count_flops_propagates_an_error():
    """An error of the counted call is raised, not turned into "no count"
    (which would drop the timing guard's floor)."""
    def fn(x):
        raise RuntimeError("the counted call failed")

    with pytest.raises(RuntimeError, match="counted call failed"):
        PC.count_flops(fn, torch.ones(2))


def test_make_train_step_is_backward_step_then_adam():
    """``make_train_step``'s step is ``train/loop.backward_step`` then the
    optimizer of ``train/loop.make_optimizer``: the same loss values,
    gradients and updated parameters as the two called by hand from the
    same weights, batch and generator seed."""
    from empose_tpu_torch.data import transforms as T
    from empose_tpu_torch.train.loop import backward_step, make_optimizer

    cfg = PC.flagship_config(tiny=True)
    host = PC.tiny_batch(np.random.RandomState(5), n=2, f=8)
    read = []
    for by_hand in (False, True):
        model, sensor = PC.build_model(cfg, seed=2)
        bank = PC.in_memory_bank(1)
        gen = torch.Generator().manual_seed(6)
        if by_hand:
            opt = make_optimizer(model, cfg)
            pre = T.make_preprocess_fn(sensor, bank, cfg, randomize_if_configured=True)
            vals = backward_step(model, pre, opt, to_device(host, "cpu"), gen)
            opt.step()
        else:
            step, opt = PC.make_train_step(model, sensor, cfg, bank=bank)
            vals = step(to_device(host, "cpu"), gen)
        assert isinstance(opt, torch.optim.Adam) and opt.defaults["lr"] == cfg.lr
        read.append((vals, {k: (p.grad.clone(), p.detach().clone())
                            for k, p in model.named_parameters()}))
    (vals, params), (vals_h, params_h) = read
    assert sorted(vals) == sorted(vals_h)
    assert all(torch.equal(vals[k], vals_h[k]) for k in vals)
    assert sorted(params) == sorted(params_h)
    for k, (g, p) in params.items():
        assert torch.equal(g, params_h[k][0]) and torch.equal(p, params_h[k][1]), k


def test_timing_guard_uses_the_h100_peak():
    """A block under the bf16-peak floor of its FLOPs is dropped and timed
    again; all blocks under it raise."""
    assert PC.plausible_floor_s(989e12) == pytest.approx(1.0)
    assert PC.plausible_floor_s(None) is None
    durations = iter([1.9, 0.0016, 2.0])
    times, n_suspect = PC.timed_blocks(lambda: next(durations), repeats=2, min_plausible_s=1.0)
    assert (times, n_suspect) == ([1.9, 2.0], 1)
    with pytest.raises(RuntimeError, match="floor"):
        PC.timed_blocks(lambda: 0.001, repeats=2, min_plausible_s=1.0, max_extra=1)


def test_run_train_step_returns_the_jax_tuple():
    """The tiny flagship at 2 x 8 on the CPU: ``(ms, flops_per_frame,
    memory, extras)`` with ``want_memory`` (memory None on the CPU), the
    3-tuple without; ``steps`` counts warm, counted and timed steps."""
    tiny = PC.flagship_config(tiny=True)
    ms, fpf, mem, extras = PC.run_train_step(iters=2, warmup=1, bs=2, window=8, repeats=2,
                                             want_memory=True, device="cpu", config=tiny)
    assert ms > 0 and fpf > 0 and mem is None
    assert sorted(extras) == ["ms_median", "steps", "suspect_blocks"]
    assert extras["steps"] == 1 + 1 + 2 * 2 + extras["suspect_blocks"] * 2
    assert extras["ms_median"] >= ms
    out = PC.run_train_step(iters=1, warmup=0, bs=2, window=8, repeats=1, device="cpu",
                            config=tiny)
    assert len(out) == 3
