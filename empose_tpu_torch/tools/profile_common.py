"""Shared pieces of the step profilers and ``measure_remat``.

The port's own copies of what the JAX tools import from outside the JAX
package: the flagship model, its in-memory offset bank and batches
(``__graft_entry__.py``), the released-architecture config, the window and
the fused train-step timing (``bench.py``). The tools' one timer is
``utils/profiling.timeit_chain``.

Times are wall-clock on the host around work that ends in a device
synchronize (``utils/profiling.block_until_ready``). A FLOP count has two
parts: the aten products ``torch.utils.flop_counter.FlopCounterMode`` sees,
and the custom LSTM kernels' products, which it cannot see and which are
added by hand per launch (the ``PERF.md`` kernel-table formulas).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from empose_tpu_torch.bodymodel.smplh import SMPLHModel
from empose_tpu_torch.bodymodel.synthetic import make_offset_data, make_synthetic_smplh
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data import transforms as T
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.device import precision_scope, resolve_device
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.tools.bench_serve import FLAGSHIP, TINY
from empose_tpu_torch.train.loop import backward_step, make_optimizer
from empose_tpu_torch.utils.profiling import block_until_ready

# H100 SXM dense bf16 tensor-core peak, FLOP/s: the fastest any block of a
# known FLOP count can finish, the floor of the timing guard.
PEAK_BF16_FLOPS = 989e12


def device_name(device: torch.device) -> str:
    """The name a result gives its device: the card's, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def flagship_config(tiny: bool = False) -> Configuration:
    """The released LGD-RNN-6 retrain architecture (``m_type="lgd"``),
    ``tiny``: its test widths (``__graft_entry__._flagship_config``)."""
    return Configuration.from_dict(dict(FLAGSHIP, **(TINY if tiny else {})))


def bench_config() -> Configuration:
    """The released LGD-RNN-6 architecture as ``bench.py`` builds it: the
    same model under ``m_type="ief"``, windows of 256 frames."""
    return Configuration.from_dict(dict(
        m_type="ief", m_rnn_init=True, m_use_gradient=True, m_average_shape=True,
        m_estimate_shape=False, m_num_iterations=2, m_hidden_size=512, m_num_layers=2,
        m_rnn_hidden_size=512, m_rnn_num_layers=2, m_rnn_bidirectional=False,
        m_step_size=0.1, m_reprojection_loss_weight=0.01, m_fk_loss=0.1,
        m_pose_loss_weight=10.0, use_marker_pos=True, use_marker_ori=True,
        use_real_offsets=True, offset_noise_level=0, n_markers=6, window_size=256,
        lr=5e-4))


def synthetic_smplh() -> SMPLHModel:
    """The synthetic SMPL-H (seed 0) with float32 tables, as the JAX
    ``_build_model`` makes it."""
    npz = make_synthetic_smplh(seed=0)
    pd = npz["posedirs"]
    return SMPLHModel(
        v_template=np.asarray(npz["v_template"], np.float32),
        shapedirs=np.asarray(npz["shapedirs"][..., :10], np.float32),
        posedirs=np.asarray(pd.reshape(-1, pd.shape[-1]).T, np.float32),
        j_regressor=np.asarray(npz["J_regressor"], np.float32),
        weights=np.asarray(npz["weights"], np.float32),
        parents=tuple(int(p) if p < 2 ** 31 else -1 for p in npz["kintree_table"][0]),
        faces=np.asarray(npz["f"], np.int64))


def build_model(config, device="cpu", seed: int = 0):
    """``(model, sensor)``: ``config``'s model on the synthetic SMPL-H with
    weights drawn from ``seed``, on ``device`` (eval mode); ``sensor`` is the
    model's own ``SensorSMPL``."""
    model = create_model(config, SensorSMPL(synthetic_smplh()))
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    return model, model.smpl


def in_memory_bank(n_subjects: int = 2, device="cpu") -> T.OffsetBank:
    """Offsets of ``n_subjects`` synthetic subjects (subject i from
    ``RandomState(i)``), no files needed."""
    offs = [make_offset_data(np.random.RandomState(i)) for i in range(n_subjects)]
    means = np.stack([o["means"] for o in offs]).astype(np.float32)
    covs = np.stack([o["covs"] for o in offs]).astype(np.float32)
    rs = np.stack([o["r"] for o in offs]).astype(np.float32)
    chol = np.linalg.cholesky(covs + 1e-12 * np.eye(3, dtype=np.float32)).astype(np.float32)
    return T.OffsetBank(*(torch.from_numpy(a).to(device) for a in (means, chol, rs)))


def tiny_batch(rng: np.random.RandomState, n: int, f: int) -> Dict[str, np.ndarray]:
    """A host batch of ``n`` windows of ``f`` frames."""
    return {"poses": rng.randn(n, f, 66).astype(np.float32) * 0.3,
            "shapes": rng.randn(n, 10).astype(np.float32) * 0.3,
            "trans": rng.randn(n, f, 3).astype(np.float32) * 0.1,
            "seq_lengths": np.full(n, f, np.int32)}


def make_window(rng: np.random.RandomState, n: int, f: int) -> Dict[str, np.ndarray]:
    """A host serving window of ``n`` sequences of ``f`` frames."""
    return {
        "marker_pos": np.asarray(rng.randn(n, f, 36), np.float32),
        "marker_ori": np.asarray(rng.randn(n, f, 108), np.float32),
        "seq_lengths": np.full(n, f, np.int32),
        "offset_t": np.asarray(rng.randn(n, 12, 3) * 0.02, np.float32),
        "offset_r": np.broadcast_to(np.eye(3, dtype=np.float32), (n, 12, 3, 3)).copy(),
    }


def make_train_step(model, sensor, config, bank: Optional[T.OffsetBank] = None):
    """One optimizer step, ``Trainer.train_step``'s own: the preprocess chain
    (``mode="all"``), the train forward, the loss with
    ``reference_grad_extra_loss`` and the gradients (``train/loop.backward_step``),
    then ``torch.optim.Adam`` (``train/loop.make_optimizer``, optax's ``adam``).

    :return: ``(step, opt)``: ``step(batch, generator)`` takes a batch of
      device tensors and a ``torch.Generator`` on the device (every draw:
      offsets, noise, dropout) and returns the loss values as device
      scalars; the gradients stay in the parameters' ``.grad``.
    """
    device = next(model.parameters()).device
    bank = bank if bank is not None else in_memory_bank(device=device)
    pre = T.make_preprocess_fn(sensor, bank, config, randomize_if_configured=True)
    opt = make_optimizer(model, config)

    def step(batch, generator):
        vals = backward_step(model, pre, opt, batch, generator)
        opt.step()
        return vals

    return step, opt


def launch_counts() -> Dict[str, int]:
    """Launches so far of the LSTM kernels a profiled stage can run."""
    return {"lstm_stack": K.LAUNCHES, "lstm_train_fwd": TK.FWD_LAUNCHES,
            "lstm_train_bwd": TK.BWD_LAUNCHES}


def lstm_flops_per_launch(f: int, n: int, h: int, layers: int) -> Dict[str, float]:
    """Hand counts of one launch of each LSTM kernel at (F, N), width H: the
    stack 2·F·N·H·4H·(2L−1) (L recurrent and L−1 input products), each
    training sweep of one direction-layer 2·F·N·H·4H."""
    sweep = 2.0 * f * n * h * 4 * h
    return {"lstm_stack": sweep * (2 * layers - 1), "lstm_train_fwd": sweep,
            "lstm_train_bwd": sweep}


class FlopCount(NamedTuple):
    counted: float   # aten products, FlopCounterMode
    by_hand: float   # custom LSTM kernels, hand counts per launch

    @property
    def total(self) -> float:
        return self.counted + self.by_hand


def count_flops(fn: Callable, *args, per_launch: Optional[Dict[str, float]] = None
                ) -> Optional[FlopCount]:
    """The FLOPs of one ``fn(*args)`` call (the call runs once), or None
    where the call does no counted product (``bench.py``'s ``_xla_flops``
    gives None where it has no count). The aten products are counted by
    ``FlopCounterMode``; each launch of a custom LSTM kernel during the call
    adds its ``per_launch`` hand count. On the CPU the kernels' plain
    versions run as aten ops and are counted. An error of the call
    propagates."""
    from torch.utils.flop_counter import FlopCounterMode

    before = launch_counts()
    with FlopCounterMode(display=False) as mode:
        block_until_ready(fn(*args))
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    by_hand = sum(n * (per_launch or {}).get(k, 0.0) for k, n in launched.items())
    count = FlopCount(float(mode.get_total_flops()), float(by_hand))
    return count if count.total > 0 else None


def couple(tensors, scalar: torch.Tensor):
    """Add ``scalar * 1e-30`` to every floating tensor of ``tensors`` (a list,
    or a dict's values) in place: a data dependency of the next call on this
    call's output that leaves the values as they are. Returns ``tensors``."""
    eps = (scalar.detach() * 1e-30).to(torch.float32)
    seq = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    with torch.no_grad():
        for t in seq:
            if t.is_floating_point():
                t.add_(eps.to(t.dtype))
    return tensors


def plausible_floor_s(flops_block: Optional[float]) -> Optional[float]:
    """The fastest a block of ``flops_block`` FLOPs can finish on an H100:
    the dense bf16 tensor-core peak. A block below it is a measurement fault."""
    if not flops_block:
        return None
    return flops_block / PEAK_BF16_FLOPS


def timed_blocks(block_fn: Callable[[], float], repeats: int,
                 min_plausible_s: Optional[float] = None, max_extra: int = 4):
    """Run ``repeats`` timing blocks (``block_fn()`` returns its seconds),
    dropping and re-measuring, up to ``max_extra`` times, any block faster
    than ``min_plausible_s``.

    :return: (times, n_suspect).
    :raises RuntimeError: if every block was impossibly fast.
    """
    times, n_suspect, runs = [], 0, 0
    while len(times) < repeats and runs < repeats + max_extra:
        runs += 1
        dt = block_fn()
        if min_plausible_s is not None and dt < min_plausible_s:
            n_suspect += 1
            continue
        times.append(dt)
    if not times:
        raise RuntimeError(
            f"all {repeats + max_extra} timing blocks finished below the "
            f"bf16-peak floor of {min_plausible_s * 1e3:.3f} ms: the device is "
            "not being waited for; refusing to report a number")
    return times, n_suspect


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _opt_state_tensors(opt: torch.optim.Optimizer):
    return [v for s in opt.state.values() for v in s.values() if torch.is_tensor(v)]


def run_train_step(iters: int = 20, warmup: int = 3, bs: int = 12, window: int = 32,
                   precision: str = "highest", remat: bool = False, want_memory: bool = False,
                   device=None, repeats: int = 4, config: Optional[Configuration] = None):
    """Mean wall-clock of one training step of the flagship LGD-RNN-6
    (:func:`make_train_step`) at ``bs`` x ``window``, ``precision`` binding
    both knobs (restored after), ``remat`` as the trainer's ``--remat``
    (``bench.py``'s ``run_train_step_tpu``). ``config``: another model
    than the flagship (a copy takes the batch, window and remat).

    Steps chain through the model and optimizer state; best of ``repeats``
    blocks of ``iters`` steps, each block closed by a device synchronize and
    held above the bf16-peak floor of its FLOPs (:func:`timed_blocks`). The
    FLOPs come from one counted step (:func:`count_flops`).

    With ``want_memory`` on CUDA, one more step gives ``memory`` (MiB),
    XLA's ``memory_analysis`` keys read on the card: ``temp_mb`` the peak
    allocated over the step (``max_memory_allocated``) above what was
    allocated before it; ``argument_mb`` the parameters, Adam state and
    batch going in; ``output_mb`` the parameters and Adam state after. On
    the CPU ``memory`` is None.

    :return: ``(ms, flops_per_frame, memory, extras)`` with ``want_memory``,
      else ``(ms, flops_per_frame, extras)``; ``extras`` holds
      ``ms_median``, ``suspect_blocks`` and ``steps`` (every step taken).
    """
    dev = resolve_device(device)
    config = Configuration(vars(config if config is not None else flagship_config()))
    config.bs_train, config.window_size = bs, window
    config.remat = remat
    with precision_scope(precision):
        model, sensor = build_model(config, dev)
        step, opt = make_train_step(model, sensor, config)
        batch = to_device(tiny_batch(np.random.RandomState(0), n=bs, f=window), dev)
        generator = torch.Generator(dev).manual_seed(0)
        steps = 0

        def one_step():
            nonlocal steps
            steps += 1
            return step(batch, generator)

        for _ in range(warmup):
            vals = one_step()
        h = config.m_rnn_hidden_size
        flops = count_flops(one_step, per_launch=lstm_flops_per_launch(
            window, bs, h, config.m_rnn_num_layers))
        f_call = flops.total if flops else None
        mem = None
        if want_memory and dev.type == "cuda":
            params = list(model.parameters())
            torch.cuda.synchronize(dev)
            argument = _bytes(params) + _bytes(_opt_state_tensors(opt)) + _bytes(batch.values())
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            vals = one_step()
            torch.cuda.synchronize(dev)
            temp = torch.cuda.max_memory_allocated(dev) - base
            output = _bytes(params) + _bytes(_opt_state_tensors(opt))
            mem = {"temp_mb": round(temp / 2 ** 20, 1),
                   "argument_mb": round(argument / 2 ** 20, 1),
                   "output_mb": round(output / 2 ** 20, 1)}

        def block():
            nonlocal vals
            start = time.perf_counter()
            for _ in range(iters):
                vals = one_step()
            block_until_ready(vals["total_loss"])
            return time.perf_counter() - start

        floor = plausible_floor_s(f_call * iters if f_call else None)
        times, n_suspect = timed_blocks(block, repeats, floor)
    ms = float(min(times) / iters * 1e3)
    extras = {"ms_median": float(np.median(times) / iters * 1e3),
              "suspect_blocks": n_suspect, "steps": steps}
    flops_per_frame = f_call / (bs * window) if f_call else None
    return (ms, flops_per_frame, mem, extras) if want_memory else (ms, flops_per_frame, extras)
