"""What the training gates share (``convergence_gate``, ``demo_convergence``,
``demo_resume``): the gates' asset tree behind the four environment
variables, the released LGD-RNN-6 retrain config, the real test loader, the
held-out MPJPE pass, steps over a fixed batch list and step-time statistics.

The JAX tools each keep their own copy of these and point the environment
variables at their tree for the rest of the process; here :func:`asset_env`
points them for a block and puts them back after, so a caller in the same
process (``chip_smoke.py``) keeps reading its own tree.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data.datasets import make_real_loader
from empose_tpu_torch.eval.metrics import MetricsEngine
from empose_tpu_torch.tools.make_synthetic_assets import generate_all

# The tree every gate trains and evaluates on (the JAX tools' ``generate_all`` call).
GATE_TREE = dict(n_real_sequences=3, n_amass_sequences=40, n_frames=200, seed=3)
ENV_DIRS = {"SMPL_MODELS": "smpl_models", "EM_DATA_REAL": "data_real",
            "EM_DATA_SYNTH": "data_synth", "EM_EXPERIMENTS": "experiments"}


def default_assets(name: str) -> str:
    """``<temporary directory>/<name>``, the JAX tools' ``/tmp/<name>`` under ``$TMPDIR``."""
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def asset_env(assets: str, device=None):
    """Write the gates' tree at ``assets`` where it is missing
    (``make_synthetic_assets.generate_all`` at ``GATE_TREE`` on ``device``),
    point ``$SMPL_MODELS``, ``$EM_DATA_REAL``, ``$EM_DATA_SYNTH`` and
    ``$EM_EXPERIMENTS`` at it for the block, and restore them after."""
    if not os.path.exists(assets):
        generate_all(assets, device=device, **GATE_TREE)
    saved = {k: os.environ.get(k) for k in ENV_DIRS}
    os.environ.update({k: os.path.join(assets, d) for k, d in ENV_DIRS.items()})
    try:
        yield assets
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lgd_retrain_config(**overrides) -> Configuration:
    """The released LGD-RNN-6 retrain hyperparameters (reference
    README.md:210-228: batch 12 x window 32, N=2 gradient iterations, seed 17)."""
    return Configuration.from_dict(dict(dict(
        m_type="ief", m_hidden_size=512, m_num_layers=2, m_num_iterations=2,
        m_use_gradient=True, m_average_shape=True, m_rnn_init=True,
        m_rnn_hidden_size=512, m_reprojection_loss_weight=0.01, m_fk_loss=0.1,
        m_pose_loss_weight=10.0, use_marker_pos=True, use_marker_ori=True,
        use_real_offsets=True, offset_noise_level=0, n_markers=6,
        window_size=32, bs_train=12, bs_eval=12, lr=5e-4, seed=17), **overrides))


def held_out_mpjpe(trainer, metrics_engine: MetricsEngine, loader,
                   window_size: Optional[int]) -> float:
    """MPJPE in mm of ``trainer``'s model over the real recordings of
    ``loader`` (``Trainer.evaluate_test``'s serial pass)."""
    trainer.evaluate_test(loader, metrics_engine, window_size)
    return float(metrics_engine.get_metrics()["MPJPE [mm]"])


def mpjpe_fn(trainer, window_size: Optional[int]):
    """A no-argument function giving ``trainer``'s held-out MPJPE over the
    real recordings of ``$EM_DATA_REAL`` in name order, one a batch."""
    loader = make_real_loader()
    metrics_engine = MetricsEngine(trainer.smplh, trainer.device)
    return lambda: held_out_mpjpe(trainer, metrics_engine, loader, window_size)


def host_batch(batch: Dict) -> Dict[str, np.ndarray]:
    """A loader batch without its ids, as numpy arrays."""
    return {k: np.asarray(v) for k, v in batch.items() if k != "ids"}


def fixed_batches(loader, n: int) -> List[Dict[str, np.ndarray]]:
    """The first ``n`` batches of ``loader``, over as many epochs as needed."""
    batches: List[Dict[str, np.ndarray]] = []
    while len(batches) < n:
        batches.extend(host_batch(b) for b in loader)
    return batches[:n]


def run_fixed(trainer, batches: List[Dict], n: int) -> List[float]:
    """``n`` steps of ``trainer`` on ``batches`` from its global step on;
    the total loss of each (read back every step)."""
    start = trainer.global_step
    return [float(trainer.train_step(b)["total_loss"]) for b in batches[start:start + n]]


def time_stats(times: List[float]) -> Dict[str, Optional[float]]:
    """Mean, median and quartiles of step times in s (None without any)."""
    if not times:
        return dict(mean=None, p25=None, median=None, p75=None, n=0)
    p25, median, p75 = (float(v) for v in np.percentile(times, [25, 50, 75]))
    return dict(mean=float(np.mean(times)), p25=p25, median=median, p75=p75, n=len(times))
