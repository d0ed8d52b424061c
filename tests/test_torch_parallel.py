"""The port's data parallelism (``empose_tpu_torch/parallel/mesh.py``) against
the JAX package's (``empose_tpu/parallel/mesh.py``, ``tests/test_parallel.py``).

The multi-rank cases spawn two gloo ranks on the CPU
(``parallel.mesh.spawn``, a file rendezvous in a temporary directory) with
the tiny LGD-RNN of the JAX DP tests (``tools/multihost_worker.tiny_config``:
BatchNorm in the refinement MLPs) and dropout and spherical noise on, on the
synthetic asset tree of ``tests/conftest.py``.

Tolerances. A 2-rank step on 5 samples padded to 6 against the
single-process step on the 5: loss values rtol 2e-5 (the JAX test's 2e-4,
tightened; only the order of the sums differs), BatchNorm running
statistics after the first step rtol 1e-4, atol 1e-5
(``tests/test_torch_train_step.py``'s: the second refinement's inputs hold
the reconstruction gradient scaled by n*f, which multiplies the rounding of
sums taken in another order), parameters (and the
statistics, which follow them) after three steps atol 2e-3 (the JAX test's:
Adam's first update is about lr x sign(gradient), so a near-zero gradient
summed in another order can flip it, 2 x lr = 1e-3). Across the ranks, and
between a chunk of 3 steps and 3 single steps: bit for bit. The DP loss and
gradients against the JAX package's single-device ``jax.grad`` for the same
parameters and synthesized batch: ``tests/test_torch_train_step.py``'s
(losses rtol 1e-5, gradients atol 1e-4 x (1 + max |JAX gradient|)).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empose_tpu.nn.models import create_model as j_create_model
from empose_tpu.parallel import mesh as JM

from empose_tpu_torch.checkpoint.from_jax import grads_from_jax, state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.nn.models import create_model
from empose_tpu_torch.parallel import mesh as M
from empose_tpu_torch.tools.multihost_worker import run_steps, tiny_batch, tiny_config
from empose_tpu_torch.train.loop import Trainer
from tests import torch_dp_ranks
from tests.test_torch_checkpoint import _jax_params, sensors  # noqa: F401 (fixture)
from tests.test_torch_train_step import TRAIN_CFG, _batch, _pad_scale

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_CONFIG = dict(m_dropout=0.2, m_dropout_hidden=0.2, spherical_noise_strength=0.5,
                 spherical_noise_length=0.5, noise_num_markers=2)
SEED = 11


def _jax_batch(n, f, seed=0):
    rng = np.random.RandomState(seed)
    batch = tiny_batch(rng, n, f)
    batch["seq_lengths"] = rng.randint(0, f + 1, n).astype(np.int32)
    batch["ids"] = [f"seq{i}" for i in range(n)]
    return batch


@pytest.mark.parametrize("n, devices", [(5, 2), (5, 8), (3, 4), (8, 8), (1, 3)])
def test_pad_batch_to_devices_matches_jax(n, devices):
    """Wrap-around rows, zeroed lengths on the pads and extended ids, byte
    for byte those of the JAX ``pad_batch_to_devices``."""
    batch = _jax_batch(n, 4)
    got = M.pad_batch_to_devices({k: v.copy() if k != "ids" else list(v)
                                  for k, v in batch.items()}, devices)
    want = JM.pad_batch_to_devices(batch, devices)
    assert sorted(got) == sorted(want)
    assert got["ids"] == want["ids"]
    for k in want:
        if k != "ids":
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert got["poses"].shape[0] % devices == 0


def test_shard_batch_takes_each_ranks_rows():
    padded = M.pad_batch_to_devices(_jax_batch(5, 4), 2)
    shards = [M.shard_batch(padded, r, 2) for r in range(2)]
    assert all("ids" not in s for s in shards)
    for k in ("poses", "seq_lengths"):
        assert np.array_equal(np.concatenate([s[k] for s in shards]), padded[k])


def test_make_mesh_raises_as_jax():
    """Too many devices: ValueError "need N devices, have M", as in JAX; CUDA
    never falls back to fewer cards or to the CPU."""
    with pytest.raises(ValueError, match=r"need 9 devices, have 8"):
        JM.make_mesh(9)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=rf"need {have + 1} devices, have {have}"):
        M.make_mesh(have + 1, "cuda")
    assert M.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert len(M.make_mesh(have, "cuda")) == have


@pytest.mark.parametrize("n_rows, world", [(5, 2), (6, 2), (3, 4)])
def test_batch_draw_takes_rank_rows_of_the_global_draw(n_rows, world):
    """Inside the shard scope a rank's draw is its rows of the draw at the
    global batch (pads repeat the leading samples'), and the generator
    moves as it does for the global draw; outside it, the plain draw."""
    n_padded = -(-n_rows // world) * world
    f = 3
    want = torch.rand((n_rows * f, 2), generator=torch.Generator().manual_seed(1))
    want = want.reshape(n_rows, f, 2)
    rows = []
    for rank in range(world):
        g = torch.Generator().manual_seed(1)
        with M.shard_scope(M.Shard(rank, world, n_rows, n_padded)):
            got = M.batch_draw(lambda k: torch.rand((k, 2), generator=g), n_padded // world * f)
        ref = torch.Generator().manual_seed(1)
        torch.rand((n_rows * f, 2), generator=ref)
        assert torch.equal(g.get_state(), ref.get_state())
        rows.append(got.reshape(-1, f, 2))
    wrap = [i if i < n_rows else (i - n_rows) % n_rows for i in range(n_padded)]
    assert torch.equal(torch.cat(rows), want[wrap])
    g = torch.Generator().manual_seed(1)
    assert torch.equal(M.batch_draw(lambda k: torch.rand((k, 2), generator=g), 4),
                       torch.rand((4, 2), generator=torch.Generator().manual_seed(1)))


@pytest.fixture(scope="module")
def dp_steps(assets_dir, tmp_path_factory):
    """Two gloo ranks: 3 single steps and a chunk of 3 on global batches of
    5, 5 and 6 samples (5 and 5 padded to 6); the same 3 steps in this
    process alone."""
    env = {"SMPL_MODELS": os.path.join(assets_dir, "smpl_models"),
           "EM_DATA_REAL": os.path.join(assets_dir, "data_real")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        config = tiny_config(**DP_CONFIG)
        rng = np.random.RandomState(3)
        batches = [tiny_batch(rng, n=n, f=8) for n in (5, 5, 6)]
        batches[1]["seq_lengths"][[1, 3]] = [5, 0]  # a partial and an empty sample
        out = str(tmp_path_factory.mktemp("dp") / "rank%d.pt")
        M.spawn(torch_dp_ranks.trainer_steps, M.make_mesh(2, "cpu"), config, SEED, batches,
                out)
        ranks = [torch.load(out % r, weights_only=False) for r in range(2)]
        single = torch_dp_ranks.steps_and_chunk(Trainer(config, seed=SEED, device="cpu"),
                                                Trainer(config, seed=SEED, device="cpu"),
                                                batches)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ranks, single


def test_dp_step_matches_single_process(dp_steps):
    """Three 2-rank steps (BatchNorm over the global batch, offset, noise and
    dropout draws of the global batch) equal the single-process steps on the
    unpadded batches: every loss value; the BatchNorm statistics after the
    first step; the parameters and statistics after the third; parameters,
    BatchNorm statistics and the generator are bit for bit the same on both
    ranks."""
    ranks, single = dp_steps
    got = ranks[0]["singles"]
    for r in ranks[1:]:
        assert r["singles"]["vals"] == got["vals"]
        assert torch.equal(r["singles"]["generator"], got["generator"])
        for k, v in got["state"].items():
            assert torch.equal(r["singles"]["state"][k], v), k
    assert torch.equal(got["generator"], single["singles"]["generator"])
    for step, (g, w) in enumerate(zip(got["vals"], single["singles"]["vals"])):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=f"step {step} {k}")
    bn = 0
    for k, w in single["first"]["state"].items():
        if k.endswith(("running_mean", "running_var")):
            bn += 1
            np.testing.assert_allclose(ranks[0]["first"]["state"][k].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    assert bn > 0
    for k, w in single["singles"]["state"].items():
        g = got["state"][k]
        if k.endswith("num_batches_tracked"):
            assert torch.equal(g, w), k
        else:
            # The statistics of the later steps follow the parameters' flips.
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-3, err_msg=k)


def test_dp_train_step_chunk_matches_single_steps(dp_steps):
    """A chunk of 3 data-parallel steps equals 3 single data-parallel steps
    bit for bit on each rank (the JAX test holds them to rtol 2e-4)."""
    ranks, _ = dp_steps
    for r in ranks:
        assert r["chunk"]["vals"] == r["singles"]["vals"]
        assert torch.equal(r["chunk"]["generator"], r["singles"]["generator"])
        for k, v in r["singles"]["state"].items():
            assert torch.equal(r["chunk"]["state"][k], v), k


def test_dp_loss_and_grads_match_jax(sensors, tmp_path):
    """The 2-rank loss and gradients of one LGD-RNN step on a synthesized
    batch of 5 (full, partial and empty rows; padded to 6) equal the JAX
    package's single-device loss and ``jax.grad`` for the same parameters,
    and the ranks' BatchNorm statistics the JAX step's."""
    j_sensor, t_sensor = sensors
    cfg_dict = dict(TRAIN_CFG, n_markers=6)
    cfg, params, state = _jax_params(cfg_dict, j_sensor, seed=5)
    t_cfg = Configuration.from_dict(cfg_dict)
    j_model = j_create_model(cfg, j_sensor)
    win = _batch(5, seed=13)
    scale = _pad_scale(win["seq_lengths"])

    def loss_fn(p, w):
        out, new_state, _ = j_model.forward(p, state, w, train=True)
        total, vals = j_model.compute_loss(w, out)
        extra = j_model.reference_grad_extra_loss(out)
        return (total + extra) * scale, ({k: v * scale for k, v in vals.items()}, new_state)

    j_grads, (j_vals, j_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in win.items()})

    t_model = create_model(t_cfg, t_sensor)
    t_model.load_state_dict(state_dict_from_jax(params, state, t_cfg), strict=True)
    out = str(tmp_path / "rank%d.pt")
    M.spawn(torch_dp_ranks.loss_and_grads, M.make_mesh(2, "cpu"), t_model, win, out)
    ranks = [torch.load(out % r, weights_only=False) for r in range(2)]
    for k, g in ranks[0]["grads"].items():
        assert torch.equal(ranks[1]["grads"][k], g), k
    for k, b in ranks[0]["buffers"].items():
        assert torch.equal(ranks[1]["buffers"][k], b), k

    got = ranks[0]
    assert sorted(got["vals"]) == sorted(j_vals)
    for k, v in got["vals"].items():
        np.testing.assert_allclose(v, float(j_vals[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want = grads_from_jax(jax.device_get(j_grads), t_cfg)
    assert sorted(got["grads"]) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got["grads"][k].numpy(), w, rtol=0,
                                   atol=1e-4 * (1.0 + np.abs(w).max()), err_msg=k)
    want_state = state_dict_from_jax(params, jax.device_get(j_state), t_cfg)
    n_bn = 0
    for k, w in want_state.items():
        if k.endswith(("running_mean", "running_var")):
            n_bn += 1
            np.testing.assert_allclose(got["buffers"][k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert n_bn > 0


def test_multihost_worker_two_processes(assets_env, tmp_path):
    """``python -m empose_tpu_torch.tools.multihost_worker`` in two processes
    joined through a file: each prints its OK line (the DP step equals the
    single-process step on the full batch, and rank 0's parameters)."""
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "empose_tpu_torch.tools.multihost_worker",
                               str(pid), "2", init, "--device", "cpu"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True, cwd=REPO)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIHOST DP OK" in out, out
