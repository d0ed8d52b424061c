"""Framework-wide constants: sensor topology, SMPL-H skeleton, environment paths.

The port's own copy of ``empose_tpu/constants.py`` (same values, same
environment variables, same ``assets/`` fallback at the repository root), so
the port never imports the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Environment / paths (reference: configuration.py:25-28). Lazy + defaulted.
# ---------------------------------------------------------------------------

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ASSETS_DIR = os.path.join(_REPO_ROOT, "assets")


def data_dir_synth() -> str:
    """Root of the synthetic training corpora (AMASS/3DPW records)."""
    return os.environ.get("EM_DATA_SYNTH", os.path.join(DEFAULT_ASSETS_DIR, "data_synth"))


def experiment_dir() -> str:
    """Where experiment directories (config.json / checkpoints / logs) live."""
    return os.environ.get("EM_EXPERIMENTS", os.path.join(DEFAULT_ASSETS_DIR, "experiments"))


def smpl_models_dir() -> str:
    """Root of the SMPL-H body-model files."""
    return os.environ.get("SMPL_MODELS", os.path.join(DEFAULT_ASSETS_DIR, "smpl_models"))


def data_dir_real() -> str:
    """Directory with the real EM-sensor ``*_clean.npz`` / ``*_offsets.npz`` files."""
    return os.environ.get("EM_DATA_REAL", os.path.join(DEFAULT_ASSETS_DIR, "data_real"))


def default_smplh_path() -> str:
    return os.path.join(smpl_models_dir(), "smplh_amass", "neutral", "model.npz")


FPS = 60.0

# ---------------------------------------------------------------------------
# Virtual tracker vertex IDs on the SMPL-H mesh (reference: configuration.py:32-34).
# Order matches the canonical 12-sensor network input order (S_ORDER below).
# ---------------------------------------------------------------------------

VERTEX_IDS: Tuple[int, ...] = (3027, 3748, 5430, 5178, 5006, 4447, 4559, 1961, 1391, 1535, 959, 1072)

# Virtual tracker names (reference: configuration.py:37-55).
T_ROOT = "root_0"
T_HEAD = "head_1"
T_BACK = "back_8"
T_RLA = "r_wrist_3"
T_RUA = "r_arm_5"
T_RSH = "r_shoulder_7"
T_RUL = "r_leg_9"
T_RLL = "r_low_leg_11"
T_LLA = "l_wrist_2"
T_LUA = "l_arm_4"
T_LSH = "l_shoulder_6"
T_LUL = "l_leg_10"
T_LLL = "l_low_leg_12"

T_ORDER: Tuple[str, ...] = (
    T_ROOT, T_BACK, T_HEAD,
    T_RLA, T_RUA, T_RSH, T_RUL, T_RLL,
    T_LLA, T_LUA, T_LSH, T_LUL, T_LLL,
)
T_TO_IDX: Dict[str, int] = {k: i for i, k in enumerate(T_ORDER)}
T_TO_IDX_WO_ROOT: Dict[str, int] = {k: i - 1 for i, k in enumerate(T_ORDER)}
N_TRACKERS_WO_ROOT = len(T_ORDER) - 1  # the root is not a tracker

T_SKELETON_W_ROOT: Tuple[Tuple[int, int], ...] = tuple(
    (T_TO_IDX[a], T_TO_IDX[b])
    for a, b in (
        (T_ROOT, T_BACK), (T_ROOT, T_RUL), (T_ROOT, T_LUL),
        (T_BACK, T_HEAD), (T_BACK, T_RSH), (T_BACK, T_LSH),
        (T_RSH, T_RUA), (T_RUA, T_RLA),
        (T_LSH, T_LUA), (T_LUA, T_LLA),
        (T_RUL, T_RLL), (T_LUL, T_LLL),
    )
)

# Real sensor hardware names (reference: configuration.py:72-83).
S_HEAD = "ID113.Set7.Num1"
S_BACK = "ID120.Set7.Num8"
S_RLA = "ID115.Set7.Num3"
S_RUA = "ID117.Set7.Num5"
S_RSH = "ID119.Set7.Num7"
S_RUL = "ID121.Set7.Num9"
S_RLL = "ID123.Set7.Num11"
S_LLA = "ID114.Set7.Num2"
S_LUA = "ID116.Set7.Num4"
S_LSH = "ID118.Set7.Num6"
S_LUL = "ID122.Set7.Num10"
S_LLL = "ID124.Set7.Num12"

# The order in which the network expects the sensors (reference: configuration.py:86-88).
S_ORDER: Tuple[str, ...] = (
    S_BACK, S_HEAD,
    S_RLA, S_RUA, S_RSH, S_RUL, S_RLL,
    S_LLA, S_LUA, S_LSH, S_LUL, S_LLL,
)
# Indices of the 6-sensor subset within S_ORDER (reference: configuration.py:89).
S_CONFIG_6: Tuple[int, ...] = (0, 1, 2, 6, 7, 11)
S_TO_IDX_WO_ROOT: Dict[str, int] = {k: i for i, k in enumerate(S_ORDER)}
S_SKELETON_WO_ROOT: Tuple[Tuple[int, int], ...] = tuple(
    (S_TO_IDX_WO_ROOT[a], S_TO_IDX_WO_ROOT[b])
    for a, b in (
        (S_BACK, S_HEAD), (S_BACK, S_RSH), (S_BACK, S_LSH),
        (S_BACK, S_LUL), (S_BACK, S_RUL),
        (S_RSH, S_RUA), (S_RUA, S_RLA),
        (S_LSH, S_LUA), (S_LUA, S_LLA),
        (S_RUL, S_RLL), (S_LUL, S_LLL),
    )
)

# ---------------------------------------------------------------------------
# SMPL constants (reference: configuration.py:103-118).
# ---------------------------------------------------------------------------

N_JOINTS = 21  # body joints, not counting root
MAX_INDEX_ROOT_AND_BODY = 66  # (1 root + 21 body) * 3 angle-axis dofs
N_JOINTS_HAND = 15  # per hand
N_SHAPE_PARAMS = 10
N_JOINTS_SMPLH = 52  # 1 root + 21 body + 2 * 15 hand

SMPL_JOINTS: Tuple[str, ...] = (
    "root", "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2", "l_ankle",
    "r_ankle", "spine3", "l_foot", "r_foot", "neck", "l_collar", "r_collar",
    "head", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow", "l_wrist", "r_wrist",
)
SMPL_PARENTS: Tuple[int, ...] = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19)

# Visualization colors (reference: configuration.py:110-113).
COLOR_PRED = (184 / 255, 130 / 255, 0 / 255, 1.0)
COLOR_GT = (15 / 255, 127 / 255, 174 / 255, 1.0)
COLOR_PRED_12 = (3 / 255, 180 / 255, 138 / 255, 1.0)
COLOR_BIRNN = (116 / 255, 109 / 255, 144 / 255, 1.0)
