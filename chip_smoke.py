#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from empose_tpu_torch/csrc, one nvcc per
     source, all at once, with their register reports (the LBS kernel, the
     20 instantiations of the training pair (U = 1, 2, 4, 8 at highest, U =
     2, 4, 8 at high and default, per sweep), the 6 of the bidirectional
     layer kernel and the 9 of the stack kernel must not spill);
     ``cuobjdump -sass``: HMMA in every high and default instantiation of
     the stack, bidi and training kernels and in no highest one;
  3. the LSTM stack kernel and its wavefront schedule against their plain
     torch versions on the card, each with its launch plan, 0-length,
     partial and full rows and non-zero state, 0-length rows frozen bit for
     bit and a second call bit for bit equal to the first, the wavefront
     also against the stack kernel: at the released init-RNN shape (L=2,
     H=512) for the batched serving chunk (F=16, N=64), the eval window
     (F=256, N=64) and one stream's chunk (F=16, N=1), timed beside the
     plain versions and torch.nn.LSTM (cuDNN), at (16, 1) also 11 rounds of
     stack kernel, wavefront kernel, cuDNN, cuDNN, wavefront kernel, stack
     kernel, with the median and quartiles of each and of their ratios; at
     a ragged batch (33, 7) and more rows than one staging holds (3, 1300);
     at one layer of the default width H=1024 (16, 64), timed, beside the
     whole 2x1024 stack as lstm_stack runs it (two launches) and
     torch.nn.LSTM(72, 1024, 2); and at the widths that take the plan's
     other modes (3 layers at H=64, a ring of 5 slots at H=260, U=8 with all
     rows staged at H=1000);
  4. the LSTM training pair (forward and reverse sweep) against its plain
     versions at H=512 for the flagship training step (F=64, N=16), a large
     one (F=256, N=64), a ragged batch (33, 7), more rows than one staging
     of the reverse sweep holds (64, 100), one row of one step (1, 1) and
     more rows than either sweep keeps in shared memory (3, 1300), and at
     H=1024 (64, 32), where the forward sweep's ring has one slot:
     the sweeps' outputs, the gradients through the autograd function
     against torch.autograd over the plain cell, 0-length rows bit for bit,
     a second launch of each sweep bit for bit equal to the first, both
     sweeps' launch plans; at the first two and at (64, 100), median times
     beside the plain versions and cuDNN's training forward and backward;
  4b. the bidirectional layer kernel against its plain torch version at the
     released BiRNN width (H=512) for the batched serving chunk (F=16,
     N=64), the eval window (F=256, N=64), one stream (F=16, N=1), a ragged
     batch (33, 7) and more rows than one staging holds (3, 1300), and at
     the default width H=1024 (16, 32), one launch per direction, and at
     the other widths each instance and mode of the plan runs (H=64, U=8
     with fewer float4 columns than lanes; H=260, U=4, both directions in
     one grid; H=516, U=4, one direction per launch); each with its launch
     plan, 0-length, partial and full rows and non-zero state, a
     second call bit for bit equal to the first; at the first three and at
     H=1024 its median times beside the plain version and
     torch.nn.LSTM(bidirectional=True) (cuDNN);
  4c. the LBS kernel against its plain version at the full synthetic mesh
     (V=6890, J=52) for N = 512 (an export chunk), 64, 1, 600 (the
     SMPLLayer.fk call), 76 (the export's last chunk) and 7 (a ragged
     chunk), with normalized random weights and random rotations, each with
     its launch plan; at 512, 64 and 1 its median times beside the plain
     version's and torch.matmul(A, W^T)'s (cuBLAS, the blend product alone),
     and its device time alone (torch.profiler); strided R_glob/t_skin
     refused with ValueError;
  4d. the port's bench tool (``python -m
     empose_tpu_torch.tools.bench_lstm_kernels``'s main) at --batch 1 64
     --window 16 --iters 5: the stack and the wavefront kernel launch once
     per timed call;
  4e. the high and default precision modes (the kernels' bf16 tensor-core
     branches, ``cuobjdump -sass``: HMMA in each of their instantiations and
     in none of the highest ones): the stack and the wavefront at 2x512 for
     (F, N) = (16, 64), (256, 64), (16, 1) (timed), (33, 7), (3, 1300), at
     one layer of 1024 (16, 64) (timed), both at 3x448 (16, 48) and 4x352
     (16, 48) (L states a chunk in the wavefront's ring; one team on two
     ring slots at high), the bidi layer at (16, 64),
     (256, 64), (16, 1), H=1024 (16, 32) and the eval's (4096, 17) (timed),
     each at both modes against its plain version at the same mode
     (TOL_MODE; at high also closer to it than to the plain version at
     highest), with its launch plan, 0-length rows frozen bit for bit, a
     second call and a CUDA-graph replay bit for bit; times beside the plain
     version, torch.nn.LSTM in bf16 (cuDNN, a yardstick) and the bound at
     the bf16 tensor-core rate (3 passes at high); the bench tool at each
     mode; cuBLAS's bf16 product with an f32 output (the products outside
     the kernels) against an fp32 GEMM of the same bf16 values;
  4f. the training pair at high and default at phase 4's shapes (F, N) =
     (64, 16), (256, 64), (64, 100) (timed), (33, 7), (1, 1), (3, 1300) at
     H=512 and (64, 32) at H=1024: both sweeps against their plain versions
     at the mode (TOL_PAIR_MODE; at high also closer to them than to the
     plain versions at highest), their launch plans, launches counted under
     the mode, 0-length rows frozen (state) and zero (dgates) bit for bit, a
     second launch and a CUDA-graph replay bit for bit; times beside the
     plain versions, cuDNN's LSTM in bf16 (training forward; backward incl.
     dW and dx) and the bound at the bf16 tensor-core rate;
  5. the serving main path: full-width LGD-RNN-6 with seeded random weights
     written as a model.pth, served to 64 streams x 4 chunks of 16 frames
     through MultiStreamPredictor.from_experiment (with one reset, one flush
     and one idle stream) plus one StreamingPredictor session; the stack
     kernel must launch once per served forward and the served poses must
     equal the same model run with the plain LSTM version, within 1e-4;
     then step times and one profiled window;
  5b. the same for full-width BiRNN-6: the bidirectional layer kernel must
     launch twice per served forward (once per layer) and no other kernel;
  5c. the same for the RNNs at the default width (2x1024, unidirectional
     and bidirectional): the stack kernel launches once per layer (the
     whole stack does not fit in one launch), the bidirectional layer
     kernel twice per layer (once per direction);
  5d. the four served models at --precision high and default (both knobs
     bound by ``device.precision_scope``, as the serve CLI binds them): their
     kernel at the mode only, poses against the plain-LSTM model at the
     mode (TOL_SERVE_MODE), the shift from highest (largest FK joint
     difference, mm) and the batched step's p50;
  6. the training main path: full-width LGD-RNN-6 trained through
     ``python -m empose_tpu_torch.train``'s main on a synthetic asset tree
     (synthetic SMPL-H, per-subject offsets, a seeded EMR corpus) for 8
     steps, then resumed for 4; each training kernel must launch twice per
     step (once per LSTM layer), the loss must be finite, and one step must
     give the loss and every parameter gradient of the same step with the
     plain training pair (every gradient within TOL_GRAD_LGD of the largest,
     a limit set by ``--step-rounding``) and of the step with the kernel
     forward and the plain reverse sweep; then step times and one profiled
     window;
  6h. (run right after 6) sensor-fault noise: the noise functions on the
     card at the flagship batch (16 x 64), drawn and applied under
     ``torch.cuda.set_sync_debug_mode("error")``, each apply equal to its
     CPU apply on the same draws (suppression bit for bit at 6 and 12
     sensors, spherical within TOL_SPHERICAL), and the moments of 4096
     entries' draws on the card (window starts, candidate and permutation
     frequencies, the radius bound); LGD-RNN-6 trained with
     ``--suppression_noise_length 0.5 --noise_num_markers 2`` and with
     ``--spherical_noise_strength 0.5 --spherical_noise_length 0.5``, 3
     steps then 2 resumed, equal bit for bit to 5 steps at once (losses and
     weights), the first loss other than the clean run's; ``--remat``: one
     LGD-RNN-6 step from the same state and batch with and without it, the
     loss and every gradient equal bit for bit, the memory the graph holds
     after the forward, the step's peak and its p50, at window 64 and at
     windows of up to REMAT_WINDOW frames; ``--profile_dir``: two steps
     through the train CLI, the Chrome trace parses and holds both
     training kernels by name, as often as they launched;
  6b. the same for full-width BiRNN-6, 4 steps then 2 resumed: each
     training kernel launches four times per step (2 layers x 2 directions);
  6c. SMPLLayer.fk at the full mesh for a 600-frame sequence in one call:
     one LBS launch, vertices equal the CPU layer's within 1e-4, joints
     equal fk_joints; then vertex normals at the full mesh;
  6d. offline datagen (``python -m empose_tpu_torch.preprocess``'s main) on
     a seeded AMASS-style tree (4 sequences at 120 fps, one of 5200 frames,
     2600 after resampling to 60 fps: three FK chunks) and a 3DPW-style pkl:
     no kernel launch; the corpora equal the CPU run's (joints within 1e-4,
     poses, betas and trans exactly); the FK stage's frames/s;
  6e. export_visualization of one 1100-frame sequence: 6 LBS launches (3
     chunks each for GT and prediction), the npz and two OBJ files written;
  6f. real-data evaluation through ``python -m empose_tpu_torch.eval``'s
     main on a seeded real tree (8 recordings over 4 subjects: one of
     4096 frames, one of 1024, the others of 300-1536; 12 sensors from the
     port's FK and virtual sensors with
     masked sensor-frames, and a hold-out recording): full-width LGD-RNN-6
     in windows of 256 frames (the stack kernel once per window of the
     batched pass) and BiRNN-6 over whole sequences (the bidirectional layer
     kernel twice per forward); the serial pass, the host oracle and the
     plain-LSTM run give the batched table within 1e-3 (relative);
     ``--cross_subject``; the batched pass's wall time, frames/s, device
     busy time and device ops (one profiled pass); then BiRNN-6 trained 3
     steps through an eval boundary (``--eval_every 3``): one validation and
     test pass at step 2 writes the best-test checkpoint. Every training run
     of 6 and 6b ends with the CLI's final validation and test passes, which
     launch the inference kernel once (LGD-RNN-6) or twice (BiRNN-6) per
     forward; phase 4b also checks the bidirectional layer at F=4096, N=17;
     then the eval CLI at --precision default for both: the same launches
     at the mode, the table's shift from highest (TOL_EVAL_MODE), the
     batched pass's wall time and frames/s; LGD-RNN-6 under
     ``--suppression_length 0.5 --suppression_markers 2`` (the serial loop,
     one stack launch a window): rows other than the clean ones, and on the
     hold-out recording the same rows on a second run and the host
     oracle's within TOL_EVAL; the
     suppression study (``python -m empose_tpu_torch.tools.suppression_study``)
     on the hold-out recording at lengths 0, 0.5 and markers 1, 2: three
     rows, the clean one equal to the clean CLI's overall row, its
     monotonicity verdict printed (untrained weights: not held);
  6g. (run right after 6b) training at the modes: LGD-RNN-6 (4 steps) and
     BiRNN-6 (2 steps) through ``python -m empose_tpu_torch.train``'s main
     at ``--matmul_precision high`` and at ``--bf16`` from the seed of the
     highest runs: the training sweeps launch once per direction-layer and
     step at the mode, the inference kernel of the final passes at the
     mode, and nothing else; the loss after the steps beside the highest
     run's; one step against the same step with the plain pair at the mode
     (TOL_STEP_MODE); the step's p50, device ops and busy share;
  6i. (run after the eval phases) data parallelism: two gloo ranks on
     cuda:0 (``parallel.mesh.spawn``) take 3 LGD-RNN-6 steps of a global
     batch of 15 (padded to 16) x window 64, held against the same steps in
     this process (the first step's losses rtol 2e-5, the later steps' 2e-4,
     parameters and BatchNorm statistics 2e-3), the ranks bit for bit
     equal; a one-rank NCCL group's steps equal this process's bit for bit;
     the first step's gradients (the ranks' average against this
     process's: per tensor against the CPU test's bar, held at TOL_GRAD_LGD
     of the largest gradient; the entries of opposite sign and the
     parameters after step 1, Adam's sign flips);
     ``--dp_devices`` beyond the card count raises ValueError; the train CLI
     at ``--steps_per_call 8`` and 1 (17 steps, chunks of 1, 8, 8): losses
     and checkpoint bit for bit, p50 per step of each; LGD-RNN-6 served to
     64 streams over [cuda:0, cuda:0] against the unsharded outputs (1e-4),
     the stack kernel once per shard and forward; ``bulk_synthesize`` of the
     training corpus at level -1 on the card against the CPU, frames/s; the
     serving bench at ``--chunk 16 --n 100`` and ``--streams 64 --n 50``
     (p50/p95/p99, frames/s), the stack kernel once per forward;
  6k. (run after 6i) the profilers: the main functions of
     ``empose_tpu_torch.tools``' ``profile_fk`` (2048 rows),
     ``profile_forward`` (8 x 256, LGD-RNN-6 in eval mode), ``profile_train``
     (64 x 256, with and without ``--remat``), ``profile_backward`` (64 x 256
     at highest and default) and ``measure_remat`` (64x256, 128x256,
     64x512), their widths and regimes as the tools have them and their
     depth cut (PROFILE_DEPTH); each run with the counts at 0 launches
     exactly what its stages' calls give (the stack once per eval forward
     and init RNN call; the training sweeps once per LSTM layer and train
     forward or gradient), at its mode; every time above the guard's floor
     (the FLOPs at the bf16 peak, where counted); ``--remat`` holds no more
     memory at any regime, and one step at 64 x 256 with and without it
     gives the same loss and gradients bit for bit; the step's device busy
     time in a profiled window against the same step on the same batch
     unprofiled (the host's share); one ``EMRBatchLoader`` draw of 64 x 256
     against the step; the stack (F=256, N=8) and the training pair
     (F=256 N=128, F=512 N=64) against their plain versions at the shapes
     the profilers give them (in phases 3 and 4);
  6j. the asset writer and the training gates on a tree of their own
     (``tools/gate_common.asset_env`` points the four environment variables
     at it per tool and restores them; the smoke's own tree is read again
     after): ``make_synthetic_assets`` of the gates' tree on the card and
     on the CPU (draw-only arrays bit for bit, corpus joints 1e-5, sensor
     fields against float64 sensors of the same draws, wall time of each);
     ``convergence_gate``'s main at 600 steps at highest (untrained MPJPE >
     150 mm, trained < 120 mm, the loss falls, the post-resume loss
     difference 0.0, s/step with its median and quartiles); the
     suppression study of its trained model 920000 on the hold-out
     recording (monotone, held; the clean row equals the gate's own pass
     there); ``demo_convergence`` at 600 steps (MPJPE falls) and
     ``demo_resume`` at K=10 (both differences 0.0); each with the counts
     at 0 and its exact launches of the training pair, the stack (windows
     of 256) and the bidi layer (H=128, whole sequences); the kernels
     against their plain versions at those shapes run with phases 3-4b;
     a "wall time of" line closes every phase, and a "phases (s)" line
     before the total gathers them;
  7. a "kernels" JSON line (a row per kernel, and per kernel and mode,
     "<kernel>@high" and "<kernel>@default"); 8. a last JSON line with the
     device.

    python3 chip_smoke.py --step-rounding [N_SEEDS, default 4] [MODE] [MODEL]

reads how far rounding alone moves a full-width LGD-RNN-6 (MODEL ``lgd``,
the default) or BiRNN-6 (``birnn``) train step at MODE (default
``highest``; ``high``, ``default``) (``step_rounding_study``), at many
trained states, beside the kernel pair: it sets TOL_GRAD_LGD and
TOL_STEP_MODE.

    python3 chip_smoke.py --step-probe [MODE, default highest] [F, default 64]

reads the time per step of the forward and the reverse sweep, of the
bidirectional layer and of the stack (2x512 in both schedules, and one layer
of 1024; each also as device time alone) at F steps for N = 1, 4, 16, 17, 32
and 64 at MODE (``step_probe``): what a step is made of beyond its grid
barriers.

    python3 chip_smoke.py --profilers

builds the stack and training kernels and runs phase 6k alone on the
smoke's asset tree (``profilers_only``): its lines and checks, no kernels
line.

    python3 chip_smoke.py --mode-rounding [N_SEEDS, default 8]

reads how far each kernel at high and default lies from its plain version
at the same mode over seeds at every shape of phases 4e and 4f, and at high
its gap to the plain version at highest (``mode_rounding_study``); the
readings set TOL_MODE and TOL_PAIR_MODE.

    PYTHONPATH=TREE python3 -P chip_smoke.py --time-pair

times both training sweeps at phase 4's timed shapes on its inputs, the
bidirectional layer at phase 4b's, and at high and default at phase 4e's
(BIDI_MODE_SHAPES), the stack and its wavefront schedule at phase 3's and
at high and default at phase 4e's, and both training sweeps at high and
default at phase 4f's (``time_pair``; each
wrapper as an event pair around one call, as device time alone and as host
time alone, with an output digest), and prints the registers and a SASS
digest of every LSTM kernel instantiation, for the package under TREE
(``-P``: not the one beside the script); runs of two trees in turns within
one call compare them:

    python3 chip_smoke.py --compare-pairs LOG...

reads the logs of such runs (``compare_pairs``, no card needed) and prints,
for every timed key and wrapper, each tree's device time alone and event
time (means over its runs) with the change, whether every output digest
equals the first tree's (exits 1 where one differs), and the instantiations
whose registers or SASS differ between the two trees.

Exits non-zero on any failure, and when no CUDA device is present.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import glob
import hashlib
import io
import itertools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from empose_tpu_torch import constants as C
from empose_tpu_torch import preprocess
from empose_tpu_torch.bodymodel.smplh import SMPLLayer, create_default_smpl_model, load_smplh
from empose_tpu_torch.bodymodel.synthetic import (make_offset_data, make_synthetic_smplh,
                                                  smooth_random_poses)
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data import noise as NZ
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.data.datasets import EMRBatchLoader, make_real_loader
from empose_tpu_torch.data.emr import EMRReader, EMRWriter
from empose_tpu_torch.device import set_precision
from empose_tpu_torch.eval import cli as eval_cli
from empose_tpu_torch.eval import harness as EH
from empose_tpu_torch.eval.harness import export_visualization
from empose_tpu_torch.eval.metrics import METRIC_NAMES, MetricsEngine
from empose_tpu_torch.nn.layers import _reverse_by_length, init_parameters, nn_precision
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import cuda_build
from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.ops import skinning as SK
from empose_tpu_torch.parallel.mesh import init_distributed, spawn
from empose_tpu_torch.serve import MultiStreamPredictor, StreamingPredictor
from empose_tpu_torch.tools import (bench_lstm_kernels, bench_serve, bulk_synthesize,
                                    convergence_gate, demo_convergence, demo_resume,
                                    make_synthetic_assets, measure_remat, profile_backward,
                                    profile_fk, profile_forward, profile_train,
                                    suppression_study)
from empose_tpu_torch.tools import profile_common as PROFILE
from empose_tpu_torch.tools.gate_common import (GATE_TREE, asset_env, held_out_mpjpe,
                                                lgd_retrain_config)
from empose_tpu_torch.tools.multihost_worker import run_steps
from empose_tpu_torch.train import cli as train_cli
from empose_tpu_torch.train.loop import Trainer
from empose_tpu_torch.utils.experiments import count_parameters
from empose_tpu_torch.utils.profiling import chain_calls, timeit_ms

SEED = 0
TOL = 1e-4
TOL_REL = 1e-4       # training pair vs plain: max abs error over max abs value
TOL_GRAD_REL = 1e-4  # a whole train step, kernel vs plain pair: max abs error / largest gradient
# The same for LGD-RNN-6, whose loop amplifies rounding: about twice the
# largest reading of an fp64-rounded plain forward against the plain pair,
# 2.28e-3, over 38 states on an H100 (``--step-rounding``, 4 and 8 seeds).
TOL_GRAD_LGD = 5e-3
TRAIN_WINDOW, TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS = 64, 16, 8, 4
# The flagship step, a large one, and one past the reverse sweep's shared step operands.
PAIR_TIMED = ((TRAIN_WINDOW, TRAIN_BATCH), (256, 64), (64, 100))
BIRNN_TRAIN_STEPS, BIRNN_RESUME_STEPS = 4, 2
NOISY_STEPS, NOISY_RESUME_STEPS = 3, 2  # LGD-RNN-6 with each noise type, then all 5 at once
REMAT_WINDOW = 512   # the longer window of the --remat readings
TOL_SPHERICAL = 1e-6  # spherical noise, card against CPU on the same draws (the trigonometry)
NOISE_MOMENTS_N = 4096
# Data parallelism: a global batch of 15 (padded to 16 over 2 ranks), 3 steps;
# --steps_per_call: 17 steps at batch 8 (8 batches an epoch: chunks of 1, 8, 8).
DP_BATCH, DP_STEPS, SPC_STEPS, SPC_BATCH = 15, 3, 17, 8
STREAMS, CHUNK, CHUNKS = 64, 16, 4
# The training gates: the convergence gate's steps and kill/resume phase
# (its defaults), demo_convergence's steps, demo_resume's K.
GATE_STEPS, GATE_RESUME_K, DEMO_STEPS, DEMO_RESUME_K = 600, 30, 600, 10
DEMO_HIDDEN = 128    # demo_convergence's BiRNN: 2x128
# The bidirectional layer's timed shapes: the batched serving chunk, the eval
# window, one stream's chunk.
BIDI_TIMED = ((CHUNK, STREAMS), (256, STREAMS), (CHUNK, 1))
# The stack's (and its wavefront schedule's) timed shapes at 2x512: the same three.
STACK_TIMED = BIDI_TIMED
HIDDEN, LAYERS, N_IN = 512, 2, 6 * 12  # init RNN of LGD-RNN-6: 6 markers x (3 pos + 9 ori)
TOL_LBS = 2e-5      # LBS kernel vs plain at metre-scale coordinates (the JAX test's)
TOL_FK = 1e-5       # FK joints of the asset writer, card against CPU
V_FULL, J_FULL = 6890, 52  # full SMPL-H mesh
SMPL_FRAMES, EXPORT_FRAMES = 600, 1100
# The real-data tree of the eval phase: 8 recordings over 4 subjects, one
# of 4096 frames, one of 1024 and the others of 300-1536 (PRs 11-20 had 16
# of 1024-4096; cut for the smoke's time limit), and one hold-out
# recording; a 3DPW-style corpus of 24 sequences for the trainer's
# validation pass.
REAL_SUBJECTS = (402, 403, 404, 405)
REAL_RECORDINGS, HOLD_OUT_FRAMES, VALID_SEQUENCES = 8, 2000, 24
EVAL_BATCH = 16      # bs_eval: the config's default, which train_flags keeps
TOL_EVAL = 1e-3      # metric tables against each other: |a - b| <= 1e-3 * max(|b|, 1)
BIDI_LONG = (4096, 17)  # the longest whole-sequence forward, at more rows than the corpus holds
# The bidi layer at the modes: BIDI_TIMED, one direction per launch at
# H=1024 (16, 32), and the eval's longest forward.
BIDI_MODE_SHAPES = (*((f, n, HIDDEN) for f, n in BIDI_TIMED), (CHUNK, 32, 2 * HIDDEN),
                    (*BIDI_LONG, HIDDEN))
FP32_PEAK = 67e12    # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
BF16_PEAK = 989e12     # H100 SXM bf16 tensor-core FLOP/s, dense

# The high and default precision modes: a kernel against its plain version
# at the same mode, from ``--mode-rounding`` (8 seeds over the 16 (kernel,
# shape) cases the mode phases check, seed 0 theirs, on an H100). HIGH's
# readings reach 4.768e-07 and its gap to the plain version at highest is
# 9.239e-07 at the least (wavefront F=16 N=1), so TOL_HIGH lies between
# them, and mode_check also holds every HIGH reading under that shape's
# gap. DEFAULT sits at bf16's step, since the kernel and its plain version
# sum in different orders and a 1-ulp difference in h can round an element
# of the next step's bf16 h the other way: about twice its largest reading,
# 1.431e-04 (stack and wavefront F=3 N=1300).
MODES = ("high", "default")
TOL_HIGH = 7e-7
TOL_DEFAULT = 3e-4
TOL_MODE = {"high": TOL_HIGH, "default": TOL_DEFAULT}
# Served poses (radians) against the plain-LSTM model at the same mode: at
# high about 6x the largest reading of the four models (1.6e-07); at
# default about 5x theirs (9.074e-05); the eval table at default against
# the highest one (relative, as TOL_EVAL): about 12x the largest reading
# (7.986e-05).
TOL_SERVE_MODE = {"high": 1e-6, "default": 5e-4}
TOL_EVAL_MODE = 1e-3
# The training pair at the modes against its plain version at the same
# mode, the largest max abs error over max abs value of a sweep's outputs
# (as TOL_REL), from ``--mode-rounding`` (8 seeds over the 7 shapes of
# phase 4f, seed 0 theirs, on an H100): about twice the largest readings,
# 1.355e-06 at HIGH (reverse sweep, F=1 N=1) and 1.170e-04 at DEFAULT
# (forward sweep, F=256 N=64). At K = 4H = 2048 the reverse sweep's f32
# sums in another order come near HIGH's own distance from highest (its
# smallest gap on this measure, 5.791e-07, lies under the largest reading),
# so the check that HIGH lies closer to its plain version than to the
# plain version at highest compares the largest max abs errors of a
# sweep's outputs, as mode_check does.
TOL_PAIR_MODE = {"high": 3e-6, "default": 3e-4}
# A whole train step at the modes, kernel pair vs plain pair at the mode
# (``--step-rounding 2 MODE MODEL``, 7 states each on an H100): the loss
# (relative), the (Bi)RNN's gradients (max abs error over max abs value
# per tensor) and every gradient (max abs error over the largest gradient),
# per model and mode, at 2-4x the largest readings: LGD-RNN-6 high loss
# 6.61e-07, RNN 5.61e-05, all 6.35e-04 (TOL_GRAD_LGD); default 2.48e-04,
# 2.13e-02, 2.02e-02 (the fp64-rounded forward moves it 1.29e-02, the
# plain pair run to run 3.46e-03); BiRNN-6 high 0, 8.55e-07, 1.24e-07;
# default 8.21e-07, 4.31e-04, 2.99e-04.
TOL_STEP_MODE = {
    ("lgd", "high"): dict(loss=1e-5, rnn=2e-4, grad=TOL_GRAD_LGD),
    ("lgd", "default"): dict(loss=1e-3, rnn=5e-2, grad=5e-2),
    ("birnn", "high"): dict(loss=1e-5, rnn=1e-4, grad=TOL_GRAD_REL),
    ("birnn", "default"): dict(loss=1e-5, rnn=1e-3, grad=1e-3),
}
# Steps of each training run at a mode (phase 6g), compared with the
# highest run's loss at the same step.
MODE_TRAIN_STEPS = {"LGD-RNN-6": 4, "BiRNN-6": 2}
# The profilers (``empose_tpu_torch/tools``) at their full regimes: depth
# cut from the tools' defaults (iters 20-30, warmup 3, repeats 3-4) for the
# time limit; widths and regimes as the tools have them.
PROFILE_DEPTH = dict(iters=5, warmup=1, repeats=3)
PROFILE_FK_ROWS, PROFILE_FORWARD, PROFILE_TRAIN = 2048, (8, 256), (64, 256)
PROFILE_MODES = ("highest", "default")
REMAT_REGIMES = ("64x256", "128x256", "64x512")
# The (F, N) the profilers give the kernels beyond the phases' own shapes,
# each checked against the plain version: the stack at profile_forward's
# window, the training pair at measure_remat's regimes.
PROFILE_STACK_SHAPES = ((PROFILE_FORWARD[1], PROFILE_FORWARD[0]),)
PROFILE_PAIR_SHAPES = tuple(fn for fn in ((int(w), int(b)) for b, w in
                                          (r.split("x") for r in REMAT_REGIMES))
                            if fn not in PAIR_TIMED)
# The keys of a row of the `kernels` line besides name, route, source,
# replaces and launches.
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

# The released LGD-RNN-6 architecture (bench.py:115-126).
LGD_RNN_6 = dict(
    m_type="ief", m_rnn_init=True, m_use_gradient=True, m_average_shape=True,
    m_estimate_shape=False, m_num_iterations=2, m_hidden_size=512, m_num_layers=2,
    m_rnn_hidden_size=512, m_rnn_num_layers=2, m_rnn_bidirectional=False,
    m_step_size=0.1, m_reprojection_loss_weight=0.01, m_fk_loss=0.1,
    m_pose_loss_weight=10.0, use_marker_pos=True, use_marker_ori=True,
    use_real_offsets=True, offset_noise_level=0, n_markers=6, window_size=256, lr=5e-4)

# The released BiRNN-6 architecture (README.md:63-74, tests/test_released_configs.py:51-53):
# a 2x512 bidirectional LSTM, shape MLP 256 with frame averaging, 6 markers;
# 9,295,697 parameters.
BIRNN_6 = dict(
    m_type="rnn", m_bidirectional=True, m_hidden_size=512, m_num_layers=2,
    m_estimate_shape=True, m_shape_hidden_size=256, m_average_shape=True,
    use_marker_pos=True, use_marker_ori=True, use_real_offsets=True, offset_noise_level=0,
    n_markers=6, window_size=256, lr=5e-4)


# The RNNs that ``python -m empose_tpu_torch.train --m_type rnn
# [--m_bidirectional]`` builds without width flags: 2x1024 (config.py
# defaults), fed the BiRNN-6 inputs.
RNN_DEFAULT = dict(
    m_type="rnn", m_bidirectional=False, m_hidden_size=1024, m_num_layers=2,
    use_marker_pos=True, use_marker_ori=True, use_real_offsets=True, offset_noise_level=0,
    n_markers=6, window_size=256)
BIRNN_DEFAULT = dict(RNN_DEFAULT, m_bidirectional=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class Laps:
    """Wall time of the consecutive phases of main on the host clock, the card
    synchronized at each end: ``lap(name)`` closes the phase that began at
    the previous lap (or at construction) and prints its wall time."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def lap(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        print(f"wall time of {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


def print_card() -> bool:
    """Print the card's name and power limit (nvidia-smi) on a line of its
    own; False, with a message on stderr, where no CUDA device is present."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    return True


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def graph_ms(fn, calls: int = 10, reps: int = 15) -> float:
    """Median device time of one ``fn()`` in ms with no host work around
    it: ``calls`` calls captured in one CUDA graph, each replay timed by a
    CUDA event pair."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, warmup=2, reps=reps) / calls


def host_us(fn, calls: int = 100) -> float:
    """Host time of one ``fn()`` in us: ``calls`` calls issued back to back
    on the host clock while the device runs behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def stack_case(f: int, n: int, seed: int, h: int = HIDDEN, layers: int = LAYERS):
    """Random weights of an L-layer stack of width H (input 72) and a batch
    with 0-length, partial and full rows (one 0-length row at least where N >
    1; the one row of N=1 runs), non-zero state."""
    g = torch.Generator().manual_seed(seed)
    bound = h ** -0.5
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * bound).cuda()
    cells = [dict(w_ih=u(N_IN if l == 0 else h, 4 * h), w_hh=u(h, 4 * h),
                  b_ih=u(4 * h), b_hh=u(4 * h)) for l in range(layers)]
    x = torch.randn(f, n, N_IN, generator=g).cuda()
    lengths = torch.randint(1, f, (n,), generator=g)
    idle = max(n // 16, 1) if n > 1 else 0
    lengths[:idle] = 0
    lengths[idle: idle + n // 3] = f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().cuda()
    h0 = (torch.randn(layers, n, h, generator=g) * 0.5).cuda()
    c0 = (torch.randn(layers, n, h, generator=g) * 0.5).cuda()
    return cells, x, mask, h0, c0


def bound_ms(flops: float, n_bytes: float) -> tuple:
    """The larger of the fp32 FMA time and the memory time, and which it is."""
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, n_bytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stack_bound_ms(f: int, n: int, h: int = HIDDEN, layers: int = LAYERS) -> tuple:
    """Least time for the stack on this card: the larger of its fp32 FMA
    work over the fp32 peak and its bytes (each input read once, each
    output written once) over the memory rate."""
    h4 = 4 * h
    flops = 2.0 * f * n * h * h4 * (2 * layers - 1)
    n_bytes = 4.0 * (f * n * h4 + f * n                       # x0_proj, mask
                     + (2 * layers - 1) * h * h4 + (layers - 1) * h4  # weights, b_up
                     + 2 * layers * n * h                       # h0, c0
                     + f * n * h + 2 * layers * n * h)          # outs, hF, cF
    return bound_ms(flops, n_bytes)


def max_err(got, want) -> float:
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def frozen_rows(got, mask, h0, c0) -> bool:
    """The final states of 0-length rows equal h0/c0 bit for bit."""
    idle = mask.sum(0) == 0
    return bool((got[1][:, idle] == h0[:, idle]).all() and (got[2][:, idle] == c0[:, idle]).all())


def quartiles(xs) -> str:
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return f"median {q2:.4f} (quartiles {q1:.4f}-{q3:.4f})"


def stack_vs_cudnn_rounds(f: int, n: int, rounds: int, kernel, kernel_proj, wave,
                          cudnn) -> None:
    """``rounds`` rounds of median event times (``cuda_ms``) in turns: kernel,
    kernel with input projection, wavefront kernel, cuDNN, cuDNN, wavefront
    kernel, kernel with input projection, kernel; per round the ratio of the
    stack kernel's two times (alone, with the projection) and of the
    wavefront's two to cuDNN's two. Prints the median and quartiles of each
    and of the ratios."""
    k, kp, w, c, ratio, ratio_p, ratio_w = [], [], [], [], [], [], []
    for _ in range(rounds):
        k1, kp1, w1, c1, c2, w2, kp2, k2 = (
            cuda_ms(fn) for fn in (kernel, kernel_proj, wave, cudnn, cudnn, wave, kernel_proj,
                                   kernel))
        k += [k1, k2]
        kp += [kp1, kp2]
        w += [w1, w2]
        c += [c1, c2]
        ratio.append((k1 + k2) / (c1 + c2))
        ratio_p.append((kp1 + kp2) / (c1 + c2))
        ratio_w.append((w1 + w2) / (c1 + c2))
    print(f"stack vs cuDNN F={f} N={n}, {rounds} rounds in turns (ms): kernel {quartiles(k)}; "
          f"kernel with input projection {quartiles(kp)}; torch.nn.LSTM (cuDNN, from x) "
          f"{quartiles(c)}; kernel / cuDNN {quartiles(ratio)}; kernel with input projection / "
          f"cuDNN {quartiles(ratio_p)}", flush=True)
    print(f"wavefront vs cuDNN F={f} N={n}, the same {rounds} rounds (ms): wavefront kernel "
          f"{quartiles(w)}; wavefront / cuDNN {quartiles(ratio_w)}", flush=True)


def cudnn_stack(cells, h: int):
    """torch.nn.LSTM (cuDNN) holding the stack's weights."""
    lstm = torch.nn.LSTM(N_IN, h, len(cells)).cuda()
    with torch.no_grad():
        for l, c in enumerate(cells):
            getattr(lstm, f"weight_ih_l{l}").copy_(c["w_ih"].t())
            getattr(lstm, f"weight_hh_l{l}").copy_(c["w_hh"].t())
            getattr(lstm, f"bias_ih_l{l}").copy_(c["b_ih"])
            getattr(lstm, f"bias_hh_l{l}").copy_(c["b_hh"])
    return lstm


def stack_check(name: str, shape: str, fused, plain, args, counter: str) -> float:
    """One schedule of the stack kernel against its plain version: one launch
    per call, 0-length rows frozen bit for bit, a second call bit for bit
    equal to the first; returns the largest error."""
    launches = getattr(K, counter)
    got = fused(*args)
    again = fused(*args)
    check(getattr(K, counter) - launches == 2,
          f"{name} at {shape}: {getattr(K, counter) - launches} launches for 2 calls")
    want = plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    frozen = frozen_rows(got, args[1], args[5], args[6])
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"{name} {shape}: max_abs_err vs its plain version {err:.3e} (outs, hF, cF); 0-length "
          f"rows ({int((args[1].sum(0) == 0).sum())}) frozen bit for bit: {frozen}; a second "
          f"call bit for bit equal to the first: {repeat}", flush=True)
    check(err <= TOL, f"{name} disagrees with its plain version at {shape}: {err} > {TOL}")
    check(frozen, f"{name} changed the state of 0-length rows at {shape}")
    check(repeat, f"two {name} calls on the same inputs differ at {shape}")
    return err


def stack_phase(f: int, n: int, seed: int, h: int = HIDDEN, layers: int = LAYERS,
                rounds: int = 0, timed: bool = True) -> dict:
    """The stack kernel and (from 2 layers) its wavefront schedule at width
    ``h`` against their plain versions (``stack_check``), each with its
    launch plan, the wavefront also against the stack kernel; when
    ``timed``, median times beside the plain versions and cuDNN's stack (and
    ``rounds`` rounds in turns against cuDNN). Returns both rows."""
    cells, x, mask, h0, c0 = stack_case(f, n, seed, h, layers)
    ops = K.stack_operands(cells, x)
    args = (ops[0], mask, ops[1], ops[2], ops[3], h0, c0)
    shape = f"F={f} N={n}" + ("" if (h, layers) == (HIDDEN, LAYERS) else f" {layers}x{h}")
    lim = K.stack_limits(x.device)
    print(f"stack launch plan {shape}: {K.lstm_stack_plan(layers, n, h, *lim)._asdict()}",
          flush=True)
    err = stack_check("stack kernel", shape, K.lstm_stack_fused, K.lstm_stack_plain, args,
                      "LAUNCHES")
    wave_err = None
    if layers > 1:
        print(f"wavefront launch plan {shape}: "
              f"{K.lstm_stack_plan(layers, n, h, *lim, wavefront=True)._asdict()}", flush=True)
        wave_err = stack_check("wavefront kernel", shape, K.lstm_stack_wavefront_fused,
                               K.lstm_stack_wavefront_plain, args, "WAVEFRONT_LAUNCHES")
        wave_stack_err = max_err(K.lstm_stack_wavefront_fused(*args), K.lstm_stack_fused(*args))
        print(f"wavefront kernel {shape}: max_abs_err vs the stack kernel {wave_stack_err:.3e}",
              flush=True)
        check(wave_stack_err <= TOL, f"wavefront kernel disagrees with the stack kernel at "
                                     f"{shape}: {wave_stack_err} > {TOL}")
        wave_err = max(wave_err, wave_stack_err)
    if not timed:
        return {"stack": dict(max_abs_err=err), "wavefront": dict(max_abs_err=wave_err)}

    lstm = cudnn_stack(cells, h)
    with torch.no_grad():
        full = torch.ones_like(mask)
        lib_err = (lstm(x, (h0, c0))[0] - K.lstm_stack(cells, x, full, h0, c0, K.lstm_stack_plain)[0]
                   ).abs().max().item()
        ms = cuda_ms(lambda: K.lstm_stack_fused(*args))
        stack_ms = cuda_ms(lambda: K.lstm_stack(cells, x, mask, h0, c0))
        plain_ms = cuda_ms(lambda: K.lstm_stack_plain(*args), reps=7 if f > 64 else 15)
        library_ms = cuda_ms(lambda: lstm(x, (h0, c0)))
        if layers > 1:
            wave_ms = cuda_ms(lambda: K.lstm_stack_wavefront_fused(*args))
            wave_plain_ms = cuda_ms(lambda: K.lstm_stack_wavefront_plain(*args),
                                    reps=7 if f > 64 else 15)
        if rounds:
            stack_vs_cudnn_rounds(f, n, rounds, lambda: K.lstm_stack_fused(*args),
                                  lambda: K.lstm_stack(cells, x, mask, h0, c0),
                                  lambda: K.lstm_stack_wavefront_fused(*args),
                                  lambda: lstm(x, (h0, c0)))
    b_ms, b_by = stack_bound_ms(f, n, h, layers)
    print(f"times {shape}: kernel {ms:.4f} ms ({ms * 1e3 / (f * layers):.2f} us per (step, "
          f"layer)), kernel with input projection {stack_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.nn.LSTM (cuDNN, from x) {library_ms:.4f} ms (max diff to plain at full lengths "
          f"{lib_err:.2e}), bound {b_ms:.4f} ms by {b_by}", flush=True)
    out = {"stack": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms)}
    if layers > 1:
        print(f"wavefront times {shape}: wavefront kernel {wave_ms:.4f} ms ({f + layers - 1} "
              f"grid barriers) against the stack kernel {ms:.4f} ms ({f * layers}), wavefront "
              f"plain {wave_plain_ms:.4f} ms, torch.nn.LSTM (cuDNN) {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}", flush=True)
        out["wavefront"] = dict(max_abs_err=wave_err, ms=wave_ms, plain_ms=wave_plain_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    return out


def stack_default_width_times(f: int, n: int, seed: int) -> dict:
    """The default-width (2x1024) stack as ``lstm_stack`` runs it, one layer
    per launch of the stack kernel (two launches and layer 1's input
    projection), beside torch.nn.LSTM(72, 1024, 2) (cuDNN) and the plain
    version, on the same inputs."""
    h = 2 * HIDDEN
    cells, x, mask, h0, c0 = stack_case(f, n, seed, h, LAYERS)
    check(not K.lstm_stack_fits(LAYERS, h, *K.stack_limits(x.device)),
          "the 2x1024 stack fits one launch")
    lstm = cudnn_stack(cells, h)
    with torch.no_grad():
        launches = K.LAUNCHES
        got = K.lstm_stack(cells, x, mask, h0, c0)
        check(K.LAUNCHES - launches == LAYERS, f"2x1024 stack: {K.LAUNCHES - launches} launches")
        want = K.lstm_stack(cells, x, mask, h0, c0, K.lstm_stack_plain)
        err = max(max_err((got[0],), (want[0],)), max_err(got[1], want[1]))
        times = {"lstm_stack_ms": cuda_ms(lambda: K.lstm_stack(cells, x, mask, h0, c0)),
                 "plain_ms": cuda_ms(lambda: K.lstm_stack(cells, x, mask, h0, c0,
                                                          K.lstm_stack_plain)),
                 "cudnn_ms": cuda_ms(lambda: lstm(x, (h0, c0)))}
    print(f"2x1024 stack F={f} N={n} (lstm_stack: {LAYERS} launches, one layer each): "
          f"max_abs_err vs plain {err:.3e}; times (ms) {times}", flush=True)
    check(err <= TOL, f"the 2x1024 stack disagrees with its plain version: {err} > {TOL}")
    return dict(times, max_abs_err=err)


def bidi_bound_ms(f: int, n: int, h: int = HIDDEN) -> tuple:
    """Least time for one bidirectional layer: both directions' fp32 FMA work
    over the fp32 peak, or its bytes (each input read once, each output
    written once) over the memory rate."""
    h4 = 4 * h
    flops = 2.0 * 2 * f * n * h * h4
    n_bytes = 4.0 * (2 * f * n * h4 + f * n + 2 * h * h4 + 4 * n * h  # x_proj, mask, W_hh, h0/c0
                     + 2 * f * n * h + 4 * n * h)                      # outs, hF, cF
    return bound_ms(flops, n_bytes)


def bidi_inputs(f: int, n: int, seed: int, h: int = HIDDEN):
    """Layer 0 of a BiRNN of width ``h`` (input 72) with seeded random
    weights, a batch with 0-length, partial and full rows (one 0-length row
    at least where N > 1; the one row of N=1 runs), non-zero state; returns
    the cells, x, x reversed by length, the lengths and the kernel's
    operands (x_proj, mask, w_hh2, h0, c0)."""
    g = torch.Generator().manual_seed(seed)
    bound = h ** -0.5
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * bound).cuda()
    cells = [dict(w_ih=u(N_IN, 4 * h), w_hh=u(h, 4 * h), b_ih=u(4 * h), b_hh=u(4 * h))
             for _ in range(2)]
    x = torch.randn(f, n, N_IN, generator=g).cuda()
    lengths = torch.randint(1, f, (n,), generator=g)
    idle = max(n // 16, 1) if n > 1 else 0
    lengths[:idle] = 0
    lengths[idle: idle + n // 3] = f
    lengths = lengths.cuda()
    mask = (torch.arange(f, device="cuda")[:, None] < lengths[None]).float()
    h0 = (torch.randn(2, n, h, generator=g) * 0.5).cuda()
    c0 = (torch.randn(2, n, h, generator=g) * 0.5).cuda()
    x_rev = _reverse_by_length(x, lengths)
    x_proj = torch.stack([xs @ c["w_ih"] + c["b_ih"] + c["b_hh"]
                          for c, xs in zip(cells, (x, x_rev))], dim=1).contiguous()
    w_hh2 = torch.stack([c["w_hh"] for c in cells])
    return cells, x, x_rev, lengths, (x_proj, mask, w_hh2, h0, c0)


def bidi_phase(f: int, n: int, seed: int, h: int = HIDDEN, timed: bool = True) -> dict:
    """The bidirectional layer kernel against its plain version on layer 0
    of a BiRNN of width ``h`` (its launch plan on a line of its own; as many
    launches as the plan has), 0-length rows bit for bit, a second call bit
    for bit equal to the first; when ``timed``, median times beside the
    plain version and cuDNN's bidirectional layer."""
    cells, x, x_rev, lengths, args = bidi_inputs(f, n, seed, h)
    x_proj, mask, w_hh2, h0, c0 = args
    shape = f"F={f} N={n}" + ("" if h == HIDDEN else f" H={h}")
    plan = K.lstm_bidi_plan(n, h, *K.bidi_limits(x_proj.device))
    print(f"bidi launch plan {shape}: {plan._asdict()}", flush=True)
    launches = K.BIDI_LAUNCHES
    got = K.lstm_bidi_fused(*args)
    again = K.lstm_bidi_fused(*args)
    check(K.BIDI_LAUNCHES - launches == 2 * plan.launches,
          f"bidi kernel at {shape}: {K.BIDI_LAUNCHES - launches} launches for 2 calls, expected "
          f"{2 * plan.launches}")
    want = K.lstm_bidi_plain(*args)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    idle = lengths == 0
    frozen = bool((got[1][:, idle] == h0[:, idle]).all() and (got[2][:, idle] == c0[:, idle]).all())
    print(f"bidi kernel {shape}: max_abs_err vs plain {err:.3e} (outs, hF, cF); "
          f"0-length rows ({int(idle.sum())}) frozen bit for bit: {frozen}; a second call bit "
          f"for bit equal to the first: {repeat}", flush=True)
    check(err <= TOL, f"bidi kernel disagrees with its plain version at {shape}: {err} > {TOL}")
    check(frozen, f"bidi kernel changed the state of 0-length rows at {shape}")
    check(repeat, f"two bidi kernel calls on the same inputs differ at {shape}")
    if not timed:
        return dict(max_abs_err=err, plan=plan._asdict())

    lstm = torch.nn.LSTM(N_IN, h, 1, bidirectional=True).cuda()
    with torch.no_grad():
        for c, suffix in zip(cells, ("", "_reverse")):
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(c["w_ih"].t())
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(c["w_hh"].t())
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(c["b_ih"])
            getattr(lstm, f"bias_hh_l0{suffix}").copy_(c["b_hh"])
        full = torch.ones_like(mask)
        outs2, _ = K.lstm_bidi_layer(cells[0], cells[1], x, x.flip(0), full, h0, c0,
                                     K.lstm_bidi_plain)
        plain_full = torch.cat([outs2[:, 0], outs2[:, 1].flip(0)], dim=-1)
        lib_err = (lstm(x, (h0, c0))[0] - plain_full).abs().max().item()
        ms = cuda_ms(lambda: K.lstm_bidi_fused(*args))
        layer_ms = cuda_ms(lambda: K.lstm_bidi_layer(cells[0], cells[1], x, x_rev, mask, h0, c0))
        plain_ms = cuda_ms(lambda: K.lstm_bidi_plain(*args), warmup=1 if f > 256 else 3,
                           reps=5 if f > 64 else 15)
        library_ms = cuda_ms(lambda: lstm(x, (h0, c0)))
    b_ms, b_by = bidi_bound_ms(f, n, h)
    print(f"bidi times {shape}: kernel {ms:.4f} ms ({ms * 1e3 / f:.2f} us per step), kernel with "
          f"input projections {layer_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.nn.LSTM "
          f"bidirectional (cuDNN, from x) {library_ms:.4f} ms (max diff to plain at full lengths "
          f"{lib_err:.2e}), bound {b_ms:.4f} ms by {b_by}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, plan=plan._asdict())


def device_ms(fn, reps: int = 20) -> dict:
    """Device time per call of ``fn()`` in ms, by device op name: the self
    times of its device ops under torch.profiler over ``reps`` calls, after
    a warm-up (host time between launches is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            / 1e3 / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def random_rotations(g: torch.Generator, *shape) -> torch.Tensor:
    """Rotation matrices (*shape, 3, 3) from normalized Gaussian quaternions."""
    w, x, y, z = torch.nn.functional.normalize(torch.randn(*shape, 4, generator=g), dim=-1).unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       -1).reshape(*shape, 3, 3)


def lbs_bound_ms(n: int) -> tuple:
    """Least time for skinning n frames of the full mesh: 2*12*J + 18 fp32
    operations per (frame, vertex); bytes of R_glob, t_skin, W^T and v_posed
    read once and the vertices written once."""
    flops = float(n) * V_FULL * (2 * 12 * J_FULL + 18)
    n_bytes = 4.0 * (n * 12 * J_FULL + J_FULL * V_FULL + 2 * n * V_FULL * 3)
    return bound_ms(flops, n_bytes)


def lbs_phase(n: int, seed: int, timed: bool) -> dict:
    """The LBS kernel against its plain version at the full mesh (its launch
    plan on a line of its own); when ``timed``, the median event times of the
    wrapper, the plain version and cuBLAS's A @ W^T, and the device time of
    the kernel alone (``device_ms``)."""
    g = torch.Generator().manual_seed(seed)
    weights = torch.rand(V_FULL, J_FULL, generator=g)
    weights /= weights.sum(1, keepdim=True)
    R = random_rotations(g, n, J_FULL).cuda()
    t = torch.randn(n, J_FULL, 3, generator=g).cuda()
    v_posed = torch.randn(n, V_FULL, 3, generator=g).cuda()
    lbs, w_dev = SK.FusedLBS(weights.numpy(), "cuda"), weights.cuda()
    plan = SK.lbs_launch_plan(n, V_FULL, J_FULL)
    print(f"LBS launch plan N={n}: {plan._asdict()}", flush=True)
    got = lbs(R, t, v_posed)
    want = SK.lbs_apply_plain(w_dev, R, t, v_posed)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"LBS kernel N={n} V={V_FULL} J={J_FULL}: max_abs_err vs plain {err:.3e} "
          f"(max |v| {want.abs().max().item():.2f})", flush=True)
    check(err <= TOL_LBS, f"LBS kernel disagrees with its plain version at N={n}: {err} > {TOL_LBS}")
    if not timed:
        return dict(max_abs_err=err, plan=plan._asdict())
    a = SK.pack_transforms(R, t).contiguous()
    with torch.no_grad():
        ms = cuda_ms(lambda: lbs(R, t, v_posed))
        plain_ms = cuda_ms(lambda: SK.lbs_apply_plain(w_dev, R, t, v_posed), reps=7)
        library_ms = cuda_ms(lambda: torch.matmul(a, lbs.weights_t))
        fused = device_ms(lambda: lbs(R, t, v_posed))
        library_dev = device_ms(lambda: torch.matmul(a, lbs.weights_t))
    kernel_ms = sum(v for k, v in fused.items() if "lbs_kernel" in k)
    check(kernel_ms > 0 and all("lbs_kernel" in k for k in fused),
          f"the LBS wrapper ran other device ops than lbs_kernel: {fused}")
    b_ms, b_by = lbs_bound_ms(n)
    print(f"LBS times N={n}: kernel wrapper {ms:.4f} ms (median event time, as for the other "
          f"kernels; device time of lbs_kernel alone {kernel_ms:.4f} ms), plain {plain_ms:.4f} "
          f"ms, torch.matmul(A, W^T) (cuBLAS, blend product only) {library_ms:.4f} ms (device "
          f"time {sum(library_dev.values()):.4f} ms), bound {b_ms:.4f} ms by {b_by}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, device_ms=kernel_ms, plan=plan._asdict())


def lbs_refuses_strided() -> None:
    """R_glob and t_skin as strided slices (every other frame): the wrapper
    documents that it refuses them with ValueError and launches nothing."""
    g = torch.Generator().manual_seed(SEED)
    lbs = SK.FusedLBS(torch.rand(V_FULL, J_FULL, generator=g).numpy(), "cuda")
    R = random_rotations(g, 8, J_FULL).cuda()[::2]
    t = torch.randn(8, J_FULL, 3, generator=g).cuda()[::2]
    launches = SK.LBS_LAUNCHES
    try:
        lbs(R, t, torch.randn(4, V_FULL, 3, generator=g).cuda())
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"LBS with strided R_glob/t_skin: refused with ValueError: {refused!r}", flush=True)
    check(bool(refused) and SK.LBS_LAUNCHES == launches,
          "the LBS wrapper took a strided R_glob/t_skin instead of refusing it")


def ptxas_report(log: str) -> dict:
    """The ``-Xptxas -v`` lines of a build log (registers, stack, spills) by
    entry function (its mangled name)."""
    out, fn = {}, None
    for line in log.splitlines():
        for mark in ("Compiling entry function '", "Function properties for "):
            if mark in line:
                fn = line.split(mark)[1].split("'")[0].strip()
        if fn and ("registers" in line or "spill" in line):
            out.setdefault(fn, []).append(line.split("info    : ")[-1].strip())
    return out


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def pair_bounds(f: int, n: int, h: int = HIDDEN) -> dict:
    """Least times of the two sweeps: fp32 FMA work 2*F*N*H*4H each; bytes
    of each input read once and each output written once."""
    h4 = 4 * h
    flops = 2.0 * f * n * h * h4
    fwd_bytes = 4.0 * (f * n * h4 + f * n + h * h4 + 2 * n * h      # x_proj, mask, W_hh, h0/c0
                       + f * n * h4 + 2 * f * n * h)                # gates, h_all, c_all
    bwd_bytes = 4.0 * (3 * f * n * h + f * n * h4 + f * n + h * h4  # dh, dc, c_prev, gates, mask, W
                       + f * n * h4 + 2 * n * h)                    # dgates, dh0, dc0
    return {"fwd": bound_ms(flops, fwd_bytes), "bwd": bound_ms(flops, bwd_bytes)}


def pair_inputs(g: torch.Generator, f: int, n: int, h: int = HIDDEN):
    """Seeded operands of the training pair at (F, N, H) on the card: x_proj,
    mask, W_hh, h0, c0, the rows' lengths (0-length, partial and full rows;
    the one row of N=1 runs every step), dh_all and dc_all."""
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda()
    w_hh = ((torch.rand(h, 4 * h, generator=g) * 2 - 1) * h ** -0.5).cuda()
    x_proj = r(f, n, 4 * h, sc=0.5)
    h0, c0 = r(n, h, sc=0.5), r(n, h, sc=0.5)
    if n == 1:
        lengths = torch.full((1,), f)
    else:
        lengths = torch.randint(1, f, (n,), generator=g)
        lengths[: max(n // 16, 1)] = 0
        lengths[max(n // 16, 1): n // 16 + n // 3] = f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().cuda()
    return x_proj, mask, w_hh, h0, c0, lengths, r(f, n, h), r(f, n, h)


def train_pair_phase(f: int, n: int, seed: int, timed: bool, h: int = HIDDEN) -> dict:
    """The training pair at hidden size ``h`` against its plain versions and
    against autograd over the plain cell, 0-length rows bit for bit, a
    second launch of each sweep bit for bit equal to the first, their launch
    plans on lines of their own; when ``timed``, median times."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda()
    x_proj, mask, w_hh, h0, c0, lengths, dh_all, dc_all = pair_inputs(g, f, n, h)
    idle = lengths.cuda() == 0
    shape = f"F={f} N={n}" + ("" if h == HIDDEN else f" H={h}")

    fwd_plan = TK.lstm_train_fwd_plan(n, h)
    print(f"forward sweep launch plan {shape}: {fwd_plan._asdict()}", flush=True)
    got = TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0)
    again_f = TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0)
    want = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0)
    gates, _, c_all = want
    c_prev = torch.cat([c0[None], c_all[:-1]])
    plan = TK.lstm_train_bwd_plan(n, h)
    print(f"reverse sweep launch plan {shape}: {plan._asdict()}", flush=True)
    got_b = TK.lstm_train_bwd(dh_all, dc_all, gates, c_prev, mask, w_hh)
    again = TK.lstm_train_bwd(dh_all, dc_all, gates, c_prev, mask, w_hh)
    want_b = TK.lstm_train_bwd_plain(dh_all, dc_all, gates, c_prev, mask, w_hh)
    torch.cuda.synchronize()
    repeat_f = all(torch.equal(a, b) for a, b in zip(got, again_f))
    repeat = all(torch.equal(a, b) for a, b in zip(got_b, again))
    fwd_err = {k: rel_err(a, b) for k, a, b in zip(("gates", "h_all", "c_all"), got, want)}
    bwd_err = {k: rel_err(a, b) for k, a, b in zip(("dgates", "dh0", "dc0"), got_b, want_b)}
    fwd_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(got_b, want_b))

    # Gradients through the autograd function against autograd over the plain cell.
    w_out, w_h, w_c = r(f, n, h), r(n, h), r(n, h)

    def grads(cell):
        leaves = [t.clone().requires_grad_() for t in (x_proj, w_hh, h0, c0)]
        outs, hF, cF = cell(*leaves)
        loss = (outs * w_out).sum() + (hF * w_h).sum() + (cF * w_c).sum()
        return torch.autograd.grad(loss, leaves)

    def kernel_cell(xp, w, h, c):
        h_all, c_all = TK.LSTMCore.apply(xp, mask, w, h, c, TK.lstm_train_fwd, TK.lstm_train_bwd)
        return h_all * mask[:, :, None], h_all[-1], c_all[-1]

    kernel_grads = grads(kernel_cell)
    plain_grads = grads(lambda xp, w, h, c: K.lstm_cell_plain(xp, mask, w, h, c))
    grad_err = {k: rel_err(a, b) for k, a, b in
                zip(("dx_proj", "dW_hh", "dh0", "dc0"), kernel_grads, plain_grads)}
    frozen = bool((got[1][:, idle] == h0[idle]).all() and (got[2][:, idle] == c0[idle]).all()
                  and (got_b[0][:, idle] == 0).all() and torch.equal(got_b[1][idle], want_b[1][idle])
                  and torch.equal(got_b[2][idle], want_b[2][idle]))
    print(f"training pair {shape}: max abs error / max abs value vs plain: forward "
          f"{fwd_err}, reverse {bwd_err}; autograd vs plain cell {grad_err}; "
          f"0-length rows bit for bit (state, dgates, dh0, dc0): {frozen}; a second forward "
          f"sweep bit for bit equal to the first: {repeat_f}; a second reverse sweep: {repeat}",
          flush=True)
    worst = max(*fwd_err.values(), *bwd_err.values(), *grad_err.values())
    check(worst <= TOL_REL, f"training pair disagrees with its plain version at {shape}: "
                            f"{worst} > {TOL_REL}")
    check(frozen, f"training pair changed 0-length rows at {shape}")
    check(repeat_f, f"two forward sweeps on the same inputs differ at {shape}")
    check(repeat, f"two reverse sweeps on the same inputs differ at {shape}")
    if not timed:
        return {"fwd": dict(max_abs_err=fwd_abs), "bwd": dict(max_abs_err=bwd_abs)}

    lstm = torch.nn.LSTM(h, h, 1).cuda()
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(w_hh.t())
    x = r(f, n, h).requires_grad_()
    out_lib, _ = lstm(x, (h0[None], c0[None]))
    grad_lib = torch.ones_like(out_lib)
    lib_params = [x, *lstm.parameters()]
    times = {
        "fwd": cuda_ms(lambda: TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0)),
        "bwd": cuda_ms(lambda: TK.lstm_train_bwd(dh_all, dc_all, gates, c_prev, mask, w_hh)),
        "fwd_plain": cuda_ms(lambda: TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0),
                             reps=7 if f > 64 else 15),
        "bwd_plain": cuda_ms(lambda: TK.lstm_train_bwd_plain(dh_all, dc_all, gates, c_prev, mask,
                                                             w_hh), reps=7 if f > 64 else 15),
        "fwd_lib": cuda_ms(lambda: lstm(x, (h0[None], c0[None]))),
        "bwd_lib": cuda_ms(lambda: torch.autograd.grad(out_lib, lib_params, grad_lib,
                                                       retain_graph=True)),
    }
    bounds = pair_bounds(f, n, h)
    print(f"training pair times {shape}: forward kernel {times['fwd']:.4f} ms (plain "
          f"{times['fwd_plain']:.4f}, cuDNN training forward {times['fwd_lib']:.4f}, bound "
          f"{bounds['fwd'][0]:.4f} by {bounds['fwd'][1]}; {times['fwd'] * 1e3 / f:.2f} us per "
          f"step); reverse kernel {times['bwd']:.4f} ms "
          f"(plain {times['bwd_plain']:.4f}, cuDNN backward incl. dW and dx "
          f"{times['bwd_lib']:.4f}, bound {bounds['bwd'][0]:.4f} by {bounds['bwd'][1]}; "
          f"{times['bwd'] * 1e3 / f:.2f} us per step)", flush=True)
    return {
        "fwd": dict(max_abs_err=fwd_abs, ms=times["fwd"], plain_ms=times["fwd_plain"],
                    bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1],
                    library_ms=times["fwd_lib"], plan=fwd_plan._asdict(),
                    us_per_step=times["fwd"] * 1e3 / f),
        "bwd": dict(max_abs_err=bwd_abs, ms=times["bwd"], plain_ms=times["bwd_plain"],
                    bound_ms=bounds["bwd"][0], bound_by=bounds["bwd"][1],
                    library_ms=times["bwd_lib"], plan=plan._asdict(),
                    us_per_step=times["bwd"] * 1e3 / f),
    }


def digest(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes() for t in tensors)
                          ).hexdigest()[:16]


def stack_weights_graph_ms(ops, mode: str) -> float:
    """Device time of the bf16 form of a stack's weights (``stack_operands``'
    W_hh and W_ih of layers >= 1) at ``mode``, which a call captured in a
    CUDA graph makes anew (``ops/precision.derived`` keeps nothing during a
    capture): inside the stack's and the wavefront's ``graph_ms``."""
    return graph_ms(lambda: [K.kernel_weights(w, mode) for w in ops[1:3] if w is not None])


def time_pair() -> int:
    """``python3 chip_smoke.py --time-pair``: both training sweeps' times at
    PAIR_TIMED on phase 4's inputs, the bidirectional layer's
    (``lstm_bidi_fused``) at BIDI_TIMED on phase 4b's and at high and
    default at BIDI_MODE_SHAPES on phase 4e's, and the stack's and
    its wavefront schedule's at STACK_TIMED (2x512) and of the stack at one
    layer of 1024 (16, 64) on phase 3's, all at highest, and at high and
    default on the mode phases' inputs (keys ``stack@MODE FxN``, with the
    weights' bf16 form that a captured call makes anew); both training
    sweeps at high and default at PAIR_TIMED and at H=1024 (64, 32) on phase
    4f's inputs (keys ``fwd@MODE FxN`` and ``bwd@MODE FxN``; W_hh's bf16 form
    made once, outside the timed calls); each
    wrapper timed three ways (an event pair around one call; the device
    alone, ``graph_ms``; the host alone, ``host_us``) and with a digest of
    its outputs (equal digests: the same bits), and nothing else. It
    times the package that ``import empose_tpu_torch`` finds:
    ``PYTHONPATH=TREE python3 -P chip_smoke.py --time-pair`` (``-P``: not the
    script's own directory) times the source tree TREE, so runs of two trees
    in turns within one call (e.g. an unpacked parent commit) compare them on
    equal inputs. The script imports nothing of the package that a parent
    tree lacks at its top, so it runs on the trees of earlier slices."""
    if not print_card():
        return 2
    print(f"package: {os.path.dirname(TK.__file__)}", flush=True)
    logs = cuda_build.build([TK.NAME, K.BIDI_NAME, K.NAME], force=True, verbose=True)
    # Every LSTM kernel instantiation (the training pair, the bidi layer, the
    # stack and its wavefront schedule, at every mode): registers, and a
    # digest of its SASS (equal digests: the same instructions).
    for name in (TK.NAME, K.BIDI_NAME, K.NAME):
        regs = ptxas_report(logs[name])
        for (kernel, units, wave, mode), ins in sorted(sass_functions(name).items()):
            code = {"highest": 0, "high": 1, "default": 2}[mode]
            pattern = rf"{kernel}ILi{units}E(?:Lb{int(wave)}E)?(?:Li{code}E)?E"
            reg = next((l for fn, ls in regs.items() if re.search(pattern, fn)
                        for l in ls if "registers" in l), "")
            print(f"{mode} {kernel} U={units}" + (" wavefront" if wave else "") + f": {reg}; "
                  f"{len(ins)} instructions, SASS digest "
                  f"{hashlib.sha256(chr(10).join(ins).encode()).hexdigest()[:16]}", flush=True)
    out = {}

    def timings(key: str, fn) -> dict:
        # The event pair around one call (host and device), the device
        # alone (graph replays) and the host alone (calls issued back to back).
        return {f"{key}_ms": cuda_ms(fn), f"{key}_graph_ms": graph_ms(fn),
                f"{key}_host_us": host_us(fn), f"{key}_digest": digest(fn())}

    for f, n in PAIR_TIMED:
        g = torch.Generator().manual_seed(SEED + f + n)
        x_proj, mask, w_hh, h0, c0, _, dh_all, dc_all = pair_inputs(g, f, n)
        gates, _, c_all = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0)
        c_prev = torch.cat([c0[None], c_all[:-1]])
        row = timings("fwd", lambda: TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0))
        row.update(timings("bwd", lambda: TK.lstm_train_bwd(dh_all, dc_all, gates, c_prev, mask,
                                                           w_hh)))
        print(f"training pair times F={f} N={n}: {row}", flush=True)
        out[f"{f}x{n}"] = row
    from empose_tpu_torch.ops.precision import weight_parts

    for mode in MODES:
        for f, n, h in (*((f, n, HIDDEN) for f, n in PAIR_TIMED), (TRAIN_WINDOW, 32, 2 * HIDDEN)):
            g = torch.Generator().manual_seed(pair_seed(f, n, h))
            x_proj, mask, w_hh, h0, c0, _, dh_all, dc_all = pair_inputs(g, f, n, h)
            gates, _, c_all = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, True, mode)
            parts = weight_parts(w_hh, mode)
            fwd_args = (x_proj, mask, w_hh, h0, c0, True, mode, parts)
            args = (dh_all, dc_all, gates, torch.cat([c0[None], c_all[:-1]]), mask, w_hh, mode,
                    parts)
            shape = f"{f}x{n}" + ("" if h == HIDDEN else f" H={h}")
            out[f"fwd@{mode} {shape}"] = timings("fwd", lambda: TK.lstm_train_fwd(*fwd_args))
            print(f"forward sweep at {mode} times F={f} N={n} H={h}: {out[f'fwd@{mode} {shape}']}",
                  flush=True)
            out[f"bwd@{mode} {shape}"] = timings("bwd", lambda: TK.lstm_train_bwd(*args))
            print(f"reverse sweep at {mode} times F={f} N={n} H={h}: {out[f'bwd@{mode} {shape}']}",
                  flush=True)
    for f, n in BIDI_TIMED:
        args = bidi_inputs(f, n, seed=SEED + f + n + 1)[-1]
        out[f"bidi {f}x{n}"] = timings("bidi", lambda: K.lstm_bidi_fused(*args))
        print(f"bidi times F={f} N={n}: {out[f'bidi {f}x{n}']}", flush=True)
    for mode in MODES:  # the mode phases' inputs (W_hh's bf16 form made at the first call)
        for f, n, h in BIDI_MODE_SHAPES:
            args = bidi_mode_inputs(f, n, mode, seed=SEED + f + n + 1, h=h)[1]
            key = f"bidi@{mode} {f}x{n}" + ("" if h == HIDDEN else f" H={h}")
            out[key] = timings("bidi", lambda: K.lstm_bidi_fused(*args, mode))
            # A captured call makes W_hh's bf16 form anew (ops/precision.derived
            # keeps nothing during a capture): its device time, inside bidi_graph_ms.
            out[key]["weights_graph_ms"] = graph_ms(lambda: K.kernel_weights(args[2], mode))
            print(f"bidi at {mode} times F={f} N={n} H={h}: {out[key]}", flush=True)
    for f, n, h, layers in (*((f, n, HIDDEN, LAYERS) for f, n in STACK_TIMED),
                            (CHUNK, STREAMS, 2 * HIDDEN, 1)):
        cells, x, mask, h0, c0 = stack_case(f, n, SEED + f + n, h, layers)
        ops = K.stack_operands(cells, x)
        args = (ops[0], mask, ops[1], ops[2], ops[3], h0, c0)
        row = timings("stack", lambda: K.lstm_stack_fused(*args))
        if layers > 1:
            row.update(timings("wavefront", lambda: K.lstm_stack_wavefront_fused(*args)))
        key = f"stack {f}x{n}" + ("" if layers > 1 else f" 1x{h}")
        out[key] = row
        print(f"{key} times: {row}", flush=True)
    for mode in MODES:  # the mode phases' inputs (the weights' bf16 form made at the first call)
        for f, n, h, layers, seed in (*((f, n, HIDDEN, LAYERS, SEED + f + n) for f, n in STACK_TIMED),
                                      (CHUNK, STREAMS, 2 * HIDDEN, 1, SEED + 1024)):
            cells, x, mask, h0, c0 = stack_case(f, n, seed, h, layers)
            ops = K.stack_operands(cells, x, mode)
            args = (ops[0], mask, ops[1], ops[2], ops[3], h0, c0, mode)
            row = timings("stack", lambda: K.lstm_stack_fused(*args))
            if layers > 1:
                row.update(timings("wavefront", lambda: K.lstm_stack_wavefront_fused(*args)))
            row["weights_graph_ms"] = stack_weights_graph_ms(ops, mode)  # inside both graph_ms
            key = f"stack@{mode} {f}x{n}" + ("" if layers > 1 else f" 1x{h}")
            out[key] = row
            print(f"{key} times: {row}", flush=True)
    print(json.dumps({"package": os.path.dirname(TK.__file__), "times": out}), flush=True)
    return 0


def compare_pairs(paths) -> int:
    """``python3 chip_smoke.py --compare-pairs LOG...``: the output of
    ``--time-pair`` runs of two trees (one log a run, the trees in turns
    within one call; the first run's tree is the first tree). Prints, per
    timed key and wrapper, each tree's device time alone (graph replays) and
    event time (medians of event pairs), each the mean over the tree's runs,
    and the second tree's change from the first; whether every run's output
    digest equals the first run's; and the kernel instantiations whose
    registers or SASS digest differ between the trees. Returns 1 where an
    output digest differs, else 0. Needs no card."""
    code_line = re.compile(r"^(highest|high|default) (\w+) U=(\d+)( wavefront)?: (.*); "
                           r"\d+ instructions, SASS digest ([0-9a-f]+)$")
    runs = []  # (package, times, {instantiation: (registers, SASS digest)})
    for path in paths:
        result, code = None, {}
        with open(path) as fh:
            for line in fh:
                m = code_line.match(line.strip())
                if m:
                    code[" ".join(filter(None, m.group(1, 2, 3, 4)))] = m.group(5, 6)
                elif line.startswith("{") and '"times"' in line:
                    result = json.loads(line)
        check(result is not None, f"{path} holds no --time-pair result")
        runs.append((result["package"], result["times"], code))
    trees = list(dict.fromkeys(tree for tree, _, _ in runs))
    check(len(trees) == 2, f"--compare-pairs needs the runs of two trees, got {trees}")
    print(f"first tree {trees[0]} ({sum(t == trees[0] for t, _, _ in runs)} runs), second "
          f"{trees[1]} ({sum(t == trees[1] for t, _, _ in runs)} runs)", flush=True)
    mean = lambda tree, key, field: float(np.mean([times[key][field] for t, times, _ in runs
                                                   if t == tree]))
    differ = 0
    for key, row in runs[0][1].items():
        for wrapper in (f[:-len("_digest")] for f in row if f.endswith("_digest")):
            dev = [mean(tree, key, f"{wrapper}_graph_ms") for tree in trees]
            ev = [mean(tree, key, f"{wrapper}_ms") for tree in trees]
            same = all(times[key][f"{wrapper}_digest"] == row[f"{wrapper}_digest"]
                       for _, times, _ in runs)
            differ += not same
            print(f"{key} {wrapper}: device alone {dev[0]:.4f} -> {dev[1]:.4f} ms "
                  f"({(dev[1] / dev[0] - 1) * 100:+.1f}%), event pair {ev[0]:.4f} -> "
                  f"{ev[1]:.4f} ms; outputs {'equal' if same else 'DIFFER'}", flush=True)
    for inst in sorted(set().union(*(code for _, _, code in runs))):
        seen = [{code.get(inst) for t, _, code in runs if t == tree} for tree in trees]
        if seen[0] != seen[1]:
            print(f"{inst}: registers and SASS digest {sorted(map(str, seen[0]))} -> "
                  f"{sorted(map(str, seen[1]))}", flush=True)
    print(json.dumps({"trees": trees, "outputs_differ": differ}), flush=True)
    return 1 if differ else 0


def step_probe(mode: str = "highest", f: int = TRAIN_WINDOW, ns=(1, 4, 16, 17, 32, 64)) -> int:
    """``python3 chip_smoke.py --step-probe [MODE [F]]``: what a step of each
    training sweep, of the bidirectional layer and of the stack (2x512 in
    both schedules, and one layer of 1024) is made of at MODE (default
    highest): its time per step at F steps (default 64) for growing N
    (median event time of the wrapper over F; each also as device time
    alone, from graph replays, for the bidi layer and the stack less the
    weights' bf16 form that a captured call makes; the training sweeps at
    high and default with W_hh's bf16 form made once, outside the timed
    calls). At N=1 the staged rows and the
    products are nearly nothing, so the step is the grid barriers, the
    elementwise work and the launch; each row adds its products and, per
    block at H=512, its 2 KB of h_all[t-1] (forward, bidi) or 8 KB of
    dgates[t] (reverse; 4 KB at default, 8 KB at high as bf16), or 2 KB per
    staged state (stack: 3 per step, wavefront: 2)."""
    from empose_tpu_torch.ops.precision import weight_parts

    if not print_card():
        return 2
    cuda_build.build([TK.NAME, K.BIDI_NAME, K.NAME], force=True)
    g = torch.Generator().manual_seed(SEED)
    fwd_us, us, fwd_graph_us, graph_us = {}, {}, {}, {}
    for n in ns:
        r = lambda *s: torch.randn(*s, generator=g).cuda()
        w_hh = r(HIDDEN, 4 * HIDDEN) * HIDDEN ** -0.5
        parts = None if mode == "highest" else weight_parts(w_hh, mode)
        args = (r(f, n, HIDDEN), r(f, n, HIDDEN), r(f, n, 4 * HIDDEN), r(f, n, HIDDEN),
                torch.ones(f, n, device="cuda"), w_hh, mode, parts)
        fwd_args = (r(f, n, 4 * HIDDEN) * 0.5, args[4], w_hh, r(n, HIDDEN) * 0.5,
                    r(n, HIDDEN) * 0.5, True, mode, parts)
        fwd_us[n] = cuda_ms(lambda: TK.lstm_train_fwd(*fwd_args)) * 1e3 / f
        us[n] = cuda_ms(lambda: TK.lstm_train_bwd(*args)) * 1e3 / f
        fwd_graph_us[n] = graph_ms(lambda: TK.lstm_train_fwd(*fwd_args)) * 1e3 / f
        graph_us[n] = graph_ms(lambda: TK.lstm_train_bwd(*args)) * 1e3 / f
    for name, plan, times, graph_times in (
            ("forward", TK.lstm_train_fwd_plan, fwd_us, fwd_graph_us),
            ("reverse", TK.lstm_train_bwd_plan, us, graph_us)):
        plans = {n: plan(n, HIDDEN, precision=mode) for n in ns}
        shown = {n: p.stage_rows if mode == "highest" or name == "forward"
                 else f"{p.stages} stages of {p.k_cols} columns" for n, p in plans.items()}
        print(f"{name} sweep at {mode} per step at F={f}, us by N (plans: {shown}; rows staged "
              f"at once at highest, the ring's rows at high and default): "
              + ", ".join(f"N={n} {v:.2f} (device alone {graph_times[n]:.2f})"
                          for n, v in times.items()), flush=True)
    bidi_us, bidi_graph_us = {}, {}
    for n in ns:
        args = bidi_mode_inputs(f, n, mode, seed=SEED + n)[1]
        bidi_us[n] = cuda_ms(lambda: K.lstm_bidi_fused(*args, mode)) * 1e3 / f
        # Device alone, less W_hh's bf16 form that a captured call makes anew.
        weights_ms = 0.0 if mode == "highest" else graph_ms(lambda: K.kernel_weights(args[2], mode))
        bidi_graph_us[n] = (graph_ms(lambda: K.lstm_bidi_fused(*args, mode)) - weights_ms) * 1e3 / f
    lim = K.bidi_limits(torch.device("cuda"))
    plans = {n: K.lstm_bidi_plan(n, HIDDEN, *lim, precision=mode) for n in ns}
    print(f"bidi layer at {mode} per step at F={f}, U={plans[ns[0]].units}, us by N (plans: "
          f"{ {n: p.stage_rows for n, p in plans.items()} } rows staged at once; at high and "
          "default a ring of 16-row slots): "
          + ", ".join(f"N={n} {v:.2f} (device alone {bidi_graph_us[n]:.2f})"
                      for n, v in bidi_us.items()), flush=True)
    stack_us, stack_graph_us = {}, {}
    for name, h, layers, fn in (("stack", HIDDEN, LAYERS, K.lstm_stack_fused),
                                ("wavefront", HIDDEN, LAYERS, K.lstm_stack_wavefront_fused),
                                ("stack 1x1024", 2 * HIDDEN, 1, K.lstm_stack_fused)):
        times, graph_times = {}, {}
        for n in ns:
            cells, x, mask, h0, c0 = stack_case(f, n, SEED + n, h, layers)
            ops = K.stack_operands(cells, x, mode)
            args = (ops[0], mask, ops[1], ops[2], ops[3], h0, c0, mode)
            times[n] = cuda_ms(lambda: fn(*args)) * 1e3 / f
            # Device alone, less the weights' bf16 form that a captured call makes anew.
            weights_ms = 0.0 if mode == "highest" else stack_weights_graph_ms(ops, mode)
            graph_times[n] = (graph_ms(lambda: fn(*args)) - weights_ms) * 1e3 / f
        stack_us[name], stack_graph_us[name] = times, graph_times
        wave, lim = name == "wavefront", K.stack_limits(x.device)
        plans = {n: K.lstm_stack_plan(layers, n, h, *lim, wavefront=wave, precision=mode)
                 for n in ns}
        print(f"{name} at {mode} per step at F={f}, us by N (plans: "
              f"{ {n: (p.stage_rows, p.teams) for n, p in plans.items()} } (rows staged at "
              "once or the ring's rows, teams)): "
              + ", ".join(f"N={n} {v:.2f} (device alone {graph_times[n]:.2f})"
                          for n, v in times.items()), flush=True)
    print(json.dumps({"mode": mode, "f": f, "fwd_us_per_step": fwd_us, "bwd_us_per_step": us,
                      "fwd_device_us_per_step": fwd_graph_us, "bwd_device_us_per_step": graph_us,
                      "bidi_us_per_step": bidi_us, "bidi_device_us_per_step": bidi_graph_us,
                      "stack_us_per_step": stack_us, "stack_device_us_per_step": stack_graph_us}),
          flush=True)
    return 0


def smooth_corpus(path: str, rng, n: int, frames: tuple, prefix: str) -> None:
    """An EMR corpus of ``n`` smooth seeded pose sequences (poses, trans,
    betas) of ``frames`` = (least, most) frames."""
    with EMRWriter(os.path.join(path, "corpus.emr")) as w:
        for i in range(n):
            n_frames = int(rng.randint(frames[0], frames[1] + 1))
            t = np.linspace(0.0, 1.0, n_frames)
            ctrl_t = np.linspace(0.0, 1.0, 8)
            ctrl = rng.randn(8, 69) * 0.3
            curves = np.stack([np.interp(t, ctrl_t, ctrl[:, d]) for d in range(69)], -1)
            w.add_record({"id": f"{prefix}{i:03d}", "gender": "neutral", "n_frames": n_frames},
                         {"poses": curves[:, :66].astype(np.float32),
                          "trans": curves[:, 66:].astype(np.float32),
                          "betas": (rng.randn(10) * 0.5).astype(np.float32)})


def write_recording(path: str, seq_id: str, offsets: dict, n_frames: int, sensor: SensorSMPL,
                    rng) -> None:
    """A ``*_clean.npz`` real recording (the keys ``RealSample.from_npz_clean``
    reads): smooth seeded poses, shape and translation, the 12 sensors from
    the port's FK and virtual sensors with the subject's mounting offsets and
    2 mm of noise, and 3 gaps of 30 frames in which one sensor is missing."""
    poses = smooth_random_poses(rng, n_frames, 66, 0.35).astype(np.float32)
    shape = (rng.randn(10) * 0.5).astype(np.float32)
    trans = smooth_random_poses(rng, n_frames, 3, 0.3).astype(np.float32)
    with torch.no_grad():
        pos, ori, _, _ = sensor.markers_and_joints(torch.from_numpy(poses).cuda(),
                                                   torch.from_numpy(shape[None]).cuda(),
                                                   trans=torch.from_numpy(trans).cuda())
    pos, ori = pos.cpu().numpy(), ori.cpu().numpy()
    ori_corr = np.einsum("fmab,mbc->fmac", ori, offsets["r"])
    pos_corr = pos + np.einsum("fmab,mb->fma", ori, offsets["means"])
    pos_corr += rng.randn(*pos_corr.shape) * 0.002
    masks = np.ones((n_frames, 12), np.float32)
    for _ in range(3):
        t0 = rng.randint(0, n_frames - 30)
        masks[t0:t0 + 30, rng.randint(0, 12)] = 0.0
    np.savez(path, id=seq_id, sensor_pos=pos_corr.reshape(n_frames, -1).astype(np.float32),
             sensor_oris=ori_corr.reshape(n_frames, -1).astype(np.float32), sensor_masks=masks,
             smpl_poses=poses, smpl_shape=shape, smpl_trans=trans,
             offset_means=offsets["means"], offset_covs=offsets["covs"], offset_r=offsets["r"])


def recording_lengths(rng) -> np.ndarray:
    """REAL_RECORDINGS lengths: one of 4096 frames, one of 1024, the rest in
    300-1536 and not a multiple of 256 (every recording two windows of 256
    or more, so the serial loop threads its carry)."""
    lengths = rng.randint(300, 1537, REAL_RECORDINGS)
    lengths[0], lengths[1] = 4096, 1024
    lengths[2:] -= lengths[2:] % 256 == 0
    return lengths


def write_assets(root: str, rng) -> None:
    """The asset tree the entry points read: the synthetic SMPL-H; offsets
    of 4 subjects and of the hold-out subject 0715; REAL_RECORDINGS real recordings
    (``recording_lengths``) over the 4 subjects and one of 2000 frames of 0715 in
    ``hold_out/``; an EMR corpus of 64 smooth seeded pose sequences of
    150-300 frames (training) and a 3DPW-style one of 24 of 300-900 frames
    (validation). Points $SMPL_MODELS, $EM_DATA_REAL, $EM_DATA_SYNTH and
    $EM_EXPERIMENTS at it."""
    smpl_dir = os.path.join(root, "smpl_models", "smplh_amass", "neutral")
    real_dir = os.path.join(root, "data_real")
    emr_dir = os.path.join(root, "data_synth", "amass_emr")
    valid_dir = os.path.join(root, "data_synth", "3dpw_emr")
    for d in (smpl_dir, os.path.join(real_dir, "hold_out"), emr_dir, valid_dir):
        os.makedirs(d)
    np.savez(os.path.join(smpl_dir, "model.npz"), **make_synthetic_smplh(seed=SEED))
    offsets = {subj: make_offset_data(rng) for subj in REAL_SUBJECTS + (715,)}
    for subj, off in offsets.items():
        np.savez(os.path.join(real_dir, f"{subj:04d}_offsets.npz"), **off)
    smooth_corpus(emr_dir, rng, 64, (150, 300), "seq")
    smooth_corpus(valid_dir, rng, VALID_SEQUENCES, (300, 900), "3dpw")
    os.environ.update(SMPL_MODELS=os.path.join(root, "smpl_models"), EM_DATA_REAL=real_dir,
                      EM_DATA_SYNTH=os.path.join(root, "data_synth"),
                      EM_EXPERIMENTS=os.path.join(root, "experiments"))
    sensor = SensorSMPL(load_smplh()).cuda()
    for i, n_frames in enumerate(recording_lengths(rng)):
        subj = REAL_SUBJECTS[i % len(REAL_SUBJECTS)]
        write_recording(os.path.join(real_dir, f"{subj:04d}_rec{i:02d}_clean.npz"),
                        f"{subj:04d}_rec{i:02d}", offsets[subj], int(n_frames), sensor, rng)
    write_recording(os.path.join(real_dir, "hold_out", "0715_rec00_clean.npz"), "0715_rec00",
                    offsets[715], HOLD_OUT_FRAMES, sensor, rng)


def write_experiment(root: str, model_id: str, cfg: dict, name: str) -> int:
    """An experiment dir with a seeded full-width model.pth of ``cfg``;
    returns the parameter count."""
    config = Configuration.from_dict(cfg)
    model = create_model(config, SensorSMPL(load_smplh()))
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model_dir = os.path.join(root, "experiments", f"{model_id}-{name}")
    os.makedirs(model_dir)
    config.to_json(os.path.join(model_dir, "config.json"))
    torch.save({"model_state_dict": model.state_dict(), "iteration": 0, "epoch": 0},
               os.path.join(model_dir, "model.pth"))
    return count_parameters(model)


def sensor_feeds(sensor: SensorSMPL, n_streams: int, n_frames: int, rng):
    """Realistic sensor readings: the port's own FK and virtual sensors over
    smooth random poses, one sequence per stream. (n_streams, n_frames, 36/108)."""
    t = np.linspace(0.0, 1.0, n_frames)
    ctrl_t = np.linspace(0.0, 1.0, 6)
    ctrl = rng.randn(n_streams, 6, 66) * 0.3
    poses = np.stack([np.stack([np.interp(t, ctrl_t, ctrl[s, :, d]) for d in range(66)], -1)
                      for s in range(n_streams)]).astype(np.float32)
    with torch.no_grad():
        p = torch.from_numpy(poses.reshape(-1, 66)).cuda()
        pos, ori, _, _ = sensor.markers_and_joints(p, p.new_zeros(p.shape[0], 10))
    pos = pos.reshape(n_streams, n_frames, -1).cpu().numpy()
    ori = ori.reshape(n_streams, n_frames, -1).cpu().numpy()
    return pos, ori


def max_diff(a: dict, b: dict) -> float:
    if set(a) != set(b):
        return float("inf")
    return max(float(np.abs(a[s][k] - b[s][k]).max()) for s in a for k in a[s])


def serve_rounds(multi, feeds, offsets):
    """64 streams x 4 chunks, one batched step per chunk: stream 1 resets
    before chunk 2, stream 2 is idle in chunk 2, stream 3 sends 9 frames in
    chunk 3 and is flushed. Returns the per-step outputs."""
    pos, ori = feeds
    for s in range(STREAMS):
        multi.set_offsets(s, *offsets[s])
    outs = []
    for c in range(CHUNKS):
        if c == 2:
            multi.reset(1)
        for s in range(STREAMS):
            if c == 2 and s == 2:
                continue
            k = 9 if (c == 3 and s == 3) else CHUNK
            sl = slice(c * CHUNK, c * CHUNK + k)
            multi.push(s, pos[s, sl], ori[s, sl])
        outs.append(multi.step(flush_ids=[3] if c == 3 else ()))
    return outs


def single_session(single, feeds, offsets):
    pos, ori = feeds
    single.offset_t, single.offset_r = offsets[0]
    out = single.push(pos[0, : CHUNK * CHUNKS - 5], ori[0, : CHUNK * CHUNKS - 5])
    return {0: out}, {0: single.flush()}


def serving_times(label: str, multi, single, feeds) -> None:
    """p50 of the batched step (host packing, forward, the one download) and
    of a single-stream chunk; then one profiled window of 5 batched steps:
    device busy time (sum of kernel times), kernels launched per step and the
    largest device-time entries."""
    pos, ori = feeds

    def batched_step() -> float:
        for s in range(STREAMS):
            multi.push(s, pos[s, :CHUNK], ori[s, :CHUNK])
        t0 = time.perf_counter()
        multi.step()
        return (time.perf_counter() - t0) * 1e3

    step_ms = [batched_step() for _ in range(20)]
    single_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        single.push(pos[0, :CHUNK], ori[0, :CHUNK])
        single_ms.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(step_ms))
    print(f"{label} serving: {STREAMS} streams x chunk {CHUNK}: p50 {p50:.3f} ms per batched step "
          f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{STREAMS * CHUNK / p50 * 1e3:.1f} frames/s; single stream p50 "
          f"{float(np.median(single_ms)):.3f} ms per chunk", flush=True)

    profile_window(f"{label} serving", batched_step, 5)


def profile_window(name: str, step, n_steps: int) -> float:
    """One profiled window of ``n_steps`` calls of ``step``: wall time per
    step, device busy time (sum of device op times) and its share, device
    ops per step, and the largest device-time entries. Returns the busy ms
    per step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            / 1e3 / n_steps for e in dev}
    launches = sum(e.count for e in dev) / n_steps
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    print(f"{name} profile ({n_steps} steps, profiler on): wall {wall_ms:.3f} ms per step, device "
          f"busy {total:.3f} ms ({100 * total / wall_ms:.1f}%), {launches:.0f} device ops per "
          "step; largest: " + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    return total


def train_flags(model_cfg: dict, experiment_id: str, max_steps: int,
                resume: bool = False, eval_every: int = 10 ** 6) -> list:
    """The CLI flags of full-width training of ``model_cfg`` at the flagship
    step (window 64, batch 16), evaluation beyond the run by default."""
    cfg = dict(model_cfg, window_size=TRAIN_WINDOW, bs_train=TRAIN_BATCH, n_epochs=10,
               print_every=4, eval_every=eval_every, seed=SEED, experiment_id=experiment_id)
    flags = []
    for k, v in cfg.items():
        if v is True:
            flags.append(f"--{k}")
        elif v is not False:
            flags += [f"--{k}", str(v)]
    return flags + ["--max_steps", str(max_steps)] + (["--resume"] if resume else [])


def train_losses(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "train/total_loss"}


def stack_forward_launches(layers: int, h: int, mode: str = "highest") -> int:
    """Stack kernel launches per forward on this card at ``mode``: one where
    the whole stack fits, by the card's own SMs and shared memory, as
    lstm_stack decides, else one per layer."""
    return 1 if K.lstm_stack_fits(layers, h, *K.stack_limits(torch.device("cuda")),
                                  precision=mode) else layers


def bidi_layer_launches(n: int, h: int, mode: str = "highest") -> int:
    """Bidirectional kernel launches per layer at N rows on this card: the
    plan of lstm_bidi_fused at ``mode`` with the card's own SMs and shared
    memory."""
    return K.lstm_bidi_plan(n, h, *K.bidi_limits(torch.device("cuda")), precision=mode).launches


def reset_counts() -> None:
    K.LAUNCHES = K.BIDI_LAUNCHES = K.WAVEFRONT_LAUNCHES = TK.FWD_LAUNCHES = TK.BWD_LAUNCHES = 0
    SK.LBS_LAUNCHES = 0
    K.MODE_LAUNCHES.clear()


def counts() -> dict:
    return {"lstm_stack": K.LAUNCHES, "lstm_bidi": K.BIDI_LAUNCHES,
            "lstm_train_fwd": TK.FWD_LAUNCHES, "lstm_train_bwd": TK.BWD_LAUNCHES,
            "lbs": SK.LBS_LAUNCHES, "lstm_wavefront": K.WAVEFRONT_LAUNCHES}


def expected(**launches) -> dict:
    """The launch counts of a path: the given ones, every other kernel 0."""
    return {k: launches.get(k, 0) for k in counts()}


def serving_path(label: str, model_id: str, feeds, offsets, kernel: str, per_forward: int,
                 use_plain) -> int:
    """Serve ``model_id`` through MultiStreamPredictor.from_experiment
    (``serve_rounds``) and one StreamingPredictor session with the counts at
    0: ``kernel`` must launch ``per_forward`` times per served forward and
    no other kernel at all; the served outputs must equal the same model
    with its LSTM's plain version (``use_plain(model)``) within 1e-4. Then
    step times and one profiled window. Returns the kernel's launches."""
    multi = MultiStreamPredictor.from_experiment(model_id, n_streams=STREAMS, chunk_size=CHUNK)
    model = multi.model
    check(next(model.parameters()).is_cuda, "the model is not on the card")
    single = StreamingPredictor(model, CHUNK)

    torch.cuda.synchronize()
    reset_counts()
    served = serve_rounds(multi, feeds, offsets)
    single_out = single_session(single, feeds, offsets)
    torch.cuda.synchronize()
    launched = counts()
    forwards = len(served) + 4  # single session: 3 full chunks + 1 flush
    print(f"{label} main path: {forwards} served forwards, launches {launched}", flush=True)
    check(launched == expected(**{kernel: per_forward * forwards}),
          f"{label}: expected {per_forward} {kernel} launches per served forward and no other "
          f"kernel, got {launched} for {forwards} forwards")

    ref_model = copy.deepcopy(model)
    use_plain(ref_model)
    ref_served = serve_rounds(MultiStreamPredictor(ref_model, STREAMS, CHUNK), feeds, offsets)
    ref_single = single_session(StreamingPredictor(ref_model, CHUNK), feeds, offsets)
    check(counts() == launched, f"{label}: the plain reference launched a kernel")
    finite = all(np.isfinite(v).all() for o in served for s in o.values() for v in s.values())
    shapes_ok = served[0][0]["pose_body"].shape == (CHUNK, 63) and \
        served[3][3]["pose_body"].shape == (9, 63) and 1 in served[2] and 2 not in served[2]
    err = max(max(max_diff(a, b) for a, b in zip(served, ref_served)),
              max(max_diff(a, b) for a, b in zip(single_out, ref_single)))
    print(f"{label} main path: outputs finite {finite}, shapes {shapes_ok}, outputs "
          f"{sorted(served[0][0])}, max |kernel path - plain LSTM path| {err:.3e} over "
          f"{len(served)} steps x {STREAMS} streams and the single session", flush=True)
    check(finite and shapes_ok, f"{label}: served outputs are not finite or have wrong shapes")
    check(err <= TOL, f"{label}: served outputs differ from the plain-LSTM forward: {err} > {TOL}")
    serving_times(label, multi, single, feeds)
    return launched[kernel], served


def final_eval_forwards() -> int:
    """Forwards of the CLI's final validation and test passes: one per
    validation batch and one per recording (whole sequences)."""
    return -(-VALID_SEQUENCES // EVAL_BATCH) + REAL_RECORDINGS


def training_path(label: str, model_cfg: dict, experiment_id: str, steps: int,
                  resume_steps: int, per_step: int, eval_kernel: str,
                  eval_per_forward: int, flags: tuple = (),
                  uninterrupted_id: str = None) -> dict:
    """Train ``steps`` steps through the CLI's main with ``flags``, resume
    for ``resume_steps``; each training kernel must launch ``per_step``
    times per step (once per direction-layer), the inference kernel
    ``eval_kernel`` ``eval_per_forward`` times per forward of each run's
    final validation and test passes, and no other kernel. With
    ``uninterrupted_id`` a third run takes all the steps at once, and its
    losses and weights must equal the resumed run's bit for bit. Returns the
    trainer and the kernels' launch counts of those runs."""
    flags = list(flags)
    torch.cuda.synchronize()
    reset_counts()
    model_dir, trainer = train_cli.main(train_flags(model_cfg, experiment_id, steps) + flags)
    torch.cuda.synchronize()
    first = counts()
    check(trainer.global_step == steps, f"trained {trainer.global_step} steps")
    check(os.path.exists(os.path.join(model_dir, "checkpoint", "train_state.pt"))
          and os.path.exists(os.path.join(model_dir, "model.pth")), "no checkpoint written")
    reset_counts()
    _, trainer = train_cli.main(train_flags(model_cfg, experiment_id, steps + resume_steps,
                                            resume=True) + flags)
    torch.cuda.synchronize()
    runs = [(steps, first), (resume_steps, counts())]
    losses = train_losses(model_dir)
    print(f"{label} training main path: {steps} steps then {resume_steps} resumed, launches "
          f"{runs[0][1]} then {runs[1][1]}; losses by step "
          f"{ {k: round(v, 6) for k, v in sorted(losses.items())} }", flush=True)
    check(trainer.global_step == steps + resume_steps,
          f"the resumed run did not reach step {steps + resume_steps}")
    check(sorted(losses) == list(range(1, steps + resume_steps + 1)),
          f"the resumed run did not continue from step {steps}")
    check(all(np.isfinite(v) for v in losses.values()), "a training loss is not finite")
    if uninterrupted_id is not None:
        reset_counts()
        whole_dir, whole = train_cli.main(train_flags(model_cfg, uninterrupted_id,
                                                      steps + resume_steps) + flags)
        torch.cuda.synchronize()
        runs.append((steps + resume_steps, counts()))
        # The final passes load the best checkpoint and then restore the weights the run
        # ended with: both trainers hold their last step's weights.
        same_weights = all(torch.equal(whole.model.state_dict()[k], v)
                           for k, v in trainer.model.state_dict().items())
        print(f"{label} training: {steps} + {resume_steps} resumed against "
              f"{steps + resume_steps} at once: losses equal bit for bit "
              f"{train_losses(whole_dir) == losses}, weights {same_weights}", flush=True)
        check(train_losses(whole_dir) == losses and same_weights,
              f"{label}: the resumed run does not continue the uninterrupted one bit for bit")
        del whole
    evals = {eval_kernel: eval_per_forward * final_eval_forwards()}
    for n, got in runs:
        check(got == expected(lstm_train_fwd=per_step * n, lstm_train_bwd=per_step * n, **evals),
              f"{label}: each training kernel must launch {per_step} times per step, "
              f"{eval_kernel} {evals[eval_kernel]} times in the final passes, and no other "
              f"kernel; got {got} over {n} steps")
    return {"trainer": trainer, "model_dir": model_dir,
            "fwd": sum(got["lstm_train_fwd"] for _, got in runs),
            "bwd": sum(got["lstm_train_bwd"] for _, got in runs),
            eval_kernel: sum(got[eval_kernel] for _, got in runs)}


def fwd_in_fp64(x_proj, mask, w_hh, h0, c0, save_gates: bool = True,
                precision: str = "highest", w_parts=None):
    """The plain forward sweep computed in fp64 and rounded to fp32: an
    equally valid fp32 result, rounded elsewhere than either sweep. At high
    and default the step's product takes bf16 operands as the sweeps do
    (the fp64 h rounded or split, W_hh's form), exact in fp64, with fp64
    sums."""
    from empose_tpu_torch.ops.precision import bf16_parts

    if precision == "highest":
        out = TK.lstm_train_fwd_plain(x_proj.double(), mask.double(), w_hh.double(),
                                      h0.double(), c0.double(), save_gates)
        return tuple(t.float() for t in out)
    w = [p.double() for p in (w_parts or bf16_parts(w_hh, precision))]
    h, c = h0.double(), c0.double()
    gates_all, hs, cs = [], [], []
    for t in range(x_proj.shape[0]):
        a = [p.double() for p in bf16_parts(h, precision)]
        rec = a[0] @ w[0] if precision == "default" else a[0] @ w[0] + a[1] @ w[0] + a[0] @ w[1]
        gates = x_proj[t].double() + rec
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None] > 0
        h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
        gates_all.append(gates)
        hs.append(h)
        cs.append(c)
    out = (torch.stack(gates_all) if save_gates else None, torch.stack(hs), torch.stack(cs))
    return tuple(None if t is None else t.float() for t in out)


def step_errors(trainer, host_batch) -> dict:
    """One train step from the trainer's state on ``host_batch``, taken five
    ways: with the kernel pair; with the kernel forward and the plain
    reverse sweep (the mixed step: the same forward bits); twice with the
    plain pair (run-to-run noise: the FK backward sums with atomics); with
    the plain forward computed in fp64 and rounded to fp32 (an equally
    valid fp32 forward, rounded elsewhere: how far rounding alone moves the
    step). Gradient errors are max abs error over the model's largest
    gradient, each with the tensor where it is largest; the loss's and the
    init RNN's (per tensor, over its largest entry) are against the plain
    pair. The trainer's state is left as it was."""
    model = trainer.model
    state = copy.deepcopy(model.state_dict())
    gen_state = trainer.generator.get_state()
    params = [p for p in model.parameters()]

    def cell(fwd, bwd):
        return functools.partial(TK.lstm_cell_train, fwd=fwd, bwd=bwd)

    def step(lstm_cell):
        model.load_state_dict(state)
        trainer.generator.set_state(gen_state)
        model.rnn.lstm_train_cell = lstm_cell
        batch = trainer.pre_train(trainer.upload(host_batch), trainer.generator, mode="all")
        loss, _ = trainer.loss(batch)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = step(TK.lstm_cell_train)
    _, grads_m = step(cell(TK.lstm_train_fwd, TK.lstm_train_bwd_plain))
    loss_p, grads_p = step(cell(TK.lstm_train_fwd_plain, TK.lstm_train_bwd_plain))
    _, grads_p2 = step(cell(TK.lstm_train_fwd_plain, TK.lstm_train_bwd_plain))
    _, grads_d = step(cell(fwd_in_fp64, TK.lstm_train_bwd_plain))
    torch.cuda.synchronize()
    model.rnn.lstm_train_cell = TK.lstm_cell_train
    model.load_state_dict(state)
    trainer.generator.set_state(gen_state)
    names = [k for k, _ in model.named_parameters()]
    scale = max(float(g.abs().max()) for g in grads_p)

    def worst(ga, gb):
        errs = {k: float((a - b).abs().max()) / scale for k, a, b in zip(names, ga, gb)}
        k = max(errs, key=errs.get)
        return errs[k], k

    rnn_errs = {k: rel_err(a, b) for k, a, b in zip(names, grads_k, grads_p) if k.startswith("rnn.")}
    worst_rnn = max(rnn_errs, key=rnn_errs.get)
    return dict(loss_k=float(loss_k), loss_p=float(loss_p), loss=rel_err(loss_k, loss_p),
                rnn=(rnn_errs[worst_rnn], worst_rnn), n_grads=len(names), scale=scale,
                pair=worst(grads_k, grads_p), mixed=worst(grads_k, grads_m),
                fp64=worst(grads_d, grads_p), noise=worst(grads_p2, grads_p))


def training_step_vs_plain(label: str, trainer, per_step: int, grad_tol: float,
                           loss_tol: float = 1e-5, rnn_tol: float = TOL_REL) -> None:
    """One step from the same state and batch with the kernel pair and with
    the plain pair on the card (``step_errors``), at the precision knobs'
    mode: the loss (within ``loss_tol``, relative) and the (Bi)RNN's
    gradients (``rnn_tol``) against the plain pair; every parameter
    gradient within ``grad_tol`` of the largest gradient against the plain
    pair, and against the mixed step, which holds the reverse sweep where
    the forward values are the same bits."""
    loader = EMRBatchLoader(os.path.join(os.environ["EM_DATA_SYNTH"], "amass_emr"), TRAIN_BATCH,
                            TRAIN_WINDOW, seed=SEED + 1)
    launches = counts()
    e = step_errors(trainer, next(iter(loader)))
    check(counts() == dict(launches, lstm_train_fwd=launches["lstm_train_fwd"] + 2 * per_step,
                           lstm_train_bwd=launches["lstm_train_bwd"] + per_step),
          f"{label}: the kernel steps did not launch the sweeps once per direction-layer")
    (rnn_err, rnn_at), (pair_err, pair_at), (mixed_err, mixed_at) = e["rnn"], e["pair"], e["mixed"]
    print(f"{label} training step at {nn_precision()}, kernel pair vs plain pair: loss "
          f"{e['loss_k']:.6f} vs "
          f"{e['loss_p']:.6f} (rel {e['loss']:.2e}); init-RNN gradients, max abs error / max "
          f"abs value, largest {rnn_err:.2e} ({rnn_at}); all {e['n_grads']} gradients, max abs "
          f"error / the largest gradient ({e['scale']:.3e}): kernel pair vs plain pair "
          f"{pair_err:.2e} ({pair_at}, limit {grad_tol:.0e}) beside the fp64-rounded plain "
          f"forward vs plain pair {e['fp64'][0]:.2e} ({e['fp64'][1]}); kernel pair vs kernel "
          f"forward + plain reverse sweep {mixed_err:.2e} ({mixed_at}); plain pair against "
          f"itself, run to run, {e['noise'][0]:.2e}", flush=True)
    check(e["loss"] <= loss_tol, f"train loss differs from the plain pair: {e['loss']} > "
                                 f"{loss_tol}")
    check(rnn_err <= rnn_tol, f"gradient {rnn_at} differs from the plain pair: "
                              f"{rnn_err} > {rnn_tol}")
    check(pair_err <= grad_tol, f"gradient {pair_at} differs from the plain pair: "
                                f"{pair_err} > {grad_tol}")
    check(mixed_err <= grad_tol, f"gradient {mixed_at} differs from the step with the plain "
                                 f"reverse sweep: {mixed_err} > {grad_tol}")


def step_rounding_study(seeds=range(4), reads: int = 3, steps_between: int = 6,
                        mode: str = "highest", model: str = "lgd") -> int:
    """``python3 chip_smoke.py --step-rounding [N_SEEDS [MODE [MODEL]]]``:
    the readings that set TOL_GRAD_LGD (highest, LGD-RNN-6) and
    TOL_STEP_MODE (high and default; ``lgd`` for LGD-RNN-6, ``birnn`` for
    BiRNN-6). ``step_errors`` at ``mode`` at many states: 12 steps trained
    through the CLI at the mode (the smoke run checks 8 + 4), then for each
    seed the seeded initial weights and the states ``steps_between``, 2 *
    ``steps_between``, ... train steps on. One line per state, then a JSON
    summary of the largest readings."""
    if not print_card():
        return 2
    set_precision("highest")
    cuda_build.build([TK.NAME], force=True)
    cfg, experiment_id = (LGD_RNN_6, "900002") if model == "lgd" else (BIRNN_6, "900004")
    flags = [] if mode == "highest" else ["--matmul_precision", mode]
    rows = []
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        write_assets(root, np.random.RandomState(SEED))
        emr_dir = os.path.join(os.environ["EM_DATA_SYNTH"], "amass_emr")
        _, trainer = train_cli.main(train_flags(cfg, experiment_id, TRAIN_STEPS + RESUME_STEPS)
                                    + flags)
        check(nn_precision() == mode, f"the trainer did not bind the knobs to {mode}")
        host_batch = next(iter(EMRBatchLoader(emr_dir, TRAIN_BATCH, TRAIN_WINDOW, seed=SEED + 1)))

        def train_batches():
            for epoch in itertools.count():
                yield from EMRBatchLoader(emr_dir, TRAIN_BATCH, TRAIN_WINDOW, seed=SEED + 3 + epoch)

        def read(state: str) -> None:
            e = step_errors(trainer, host_batch)
            rows.append(dict(state=state, loss=e["loss"], rnn=e["rnn"][0],
                             **{k: e[k][0] for k in ("pair", "fp64", "mixed", "noise")}))
            print(f"step rounding {model} at {mode}, {state}: kernel pair vs plain pair "
                  f"{e['pair'][0]:.3e} ({e['pair'][1]}); fp64-rounded plain forward vs plain pair "
                  f"{e['fp64'][0]:.3e} ({e['fp64'][1]}); kernel pair vs mixed step "
                  f"{e['mixed'][0]:.3e}; plain pair run to run {e['noise'][0]:.3e}; loss rel "
                  f"{e['loss']:.2e}; (Bi)RNN gradients {e['rnn'][0]:.3e} ({e['rnn'][1]})",
                  flush=True)

        read(f"CLI-trained, {TRAIN_STEPS + RESUME_STEPS} steps")
        batches = train_batches()
        for seed in seeds:
            init_parameters(trainer.model, torch.Generator().manual_seed(seed))
            trainer.opt.state.clear()
            for r in range(reads):
                for _ in range(steps_between if r else 0):
                    trainer.train_step(next(batches))
                read(f"seed {seed}, {r * steps_between} steps from init")
    set_precision("highest")
    print(json.dumps({"step_rounding": {k: max(r[k] for r in rows)
                                        for k in ("pair", "fp64", "mixed", "noise", "loss", "rnn")},
                      "states": len(rows), "mode": mode, "model": model}), flush=True)
    return 0


def training_times(label: str, trainer) -> None:
    """p50 of a train step (upload, synthesis, forward, backward, Adam; host
    clock, synchronized) and frames/s, then one profiled window."""
    loader = EMRBatchLoader(os.path.join(os.environ["EM_DATA_SYNTH"], "amass_emr"), TRAIN_BATCH,
                            TRAIN_WINDOW, seed=SEED + 2)
    batches = [b for _ in range(3) for b in loader]  # 12 steps

    def step():
        trainer.train_step(batches[0])

    trainer.train_step(batches[0])
    times = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    frames = TRAIN_BATCH * TRAIN_WINDOW
    print(f"{label} training: batch {TRAIN_BATCH} x window {TRAIN_WINDOW}: p50 {p50:.3f} ms per step "
          f"(min {min(times):.3f}, max {max(times):.3f}, {len(times)} steps), "
          f"{frames / p50 * 1e3:.1f} frames/s", flush=True)
    profile_window(f"{label} training", step, 3)


def training_mode_path(label: str, model_cfg: dict, model: str, experiment_id: str, mode: str,
                       flags: list, per_step: int, eval_kernel: str, eval_per_forward: int,
                       base_losses: dict) -> dict:
    """Train MODE_TRAIN_STEPS[label] steps through the CLI's main with
    ``flags`` (``--matmul_precision high`` or ``--bf16``, both knobs then at
    ``mode``) from the seed of the highest run: each training sweep
    launches ``per_step`` times per step and the inference kernel
    ``eval_kernel`` ``eval_per_forward`` times per forward of the final
    passes, all at the mode, and no other kernel; the loss after the steps
    beside the highest run's (``base_losses``; the shift is what the mode
    costs, no limit); one step against the same step with the plain pair at
    the mode (TOL_STEP_MODE); the step's p50, device ops and busy share.
    Returns the launches of that run by kernel."""
    steps = MODE_TRAIN_STEPS[label]
    torch.cuda.synchronize()
    reset_counts()
    model_dir, trainer = train_cli.main(train_flags(model_cfg, experiment_id, steps) + flags)
    torch.cuda.synchronize()
    launched, by_mode = counts(), dict(K.MODE_LAUNCHES)
    losses = train_losses(model_dir)
    evals = eval_per_forward * final_eval_forwards()
    shift = losses.get(steps, float("nan")) - base_losses[steps]
    print(f"{label} training at {mode} ({' '.join(flags)}): {steps} steps, launches {launched}, "
          f"by mode {by_mode}; losses by step { {k: round(v, 6) for k, v in sorted(losses.items())} }"
          f"; loss after {steps} steps {losses.get(steps, float('nan')):.6f} against "
          f"{base_losses[steps]:.6f} at highest (shift {shift:+.3e}, relative "
          f"{shift / abs(base_losses[steps]):+.3e})", flush=True)
    check(nn_precision() == mode, f"{label}: the trainer ran at {nn_precision()}, not {mode}")
    check(trainer.global_step == steps and sorted(losses) == list(range(1, steps + 1))
          and all(np.isfinite(v) for v in losses.values()),
          f"{label} at {mode}: the run did not take {steps} steps with finite losses")
    want = {("lstm_train_fwd", mode): per_step * steps, ("lstm_train_bwd", mode): per_step * steps,
            (eval_kernel, mode): evals}
    check(launched == expected(lstm_train_fwd=per_step * steps, lstm_train_bwd=per_step * steps,
                               **{eval_kernel: evals}) and by_mode == want,
          f"{label} at {mode}: expected the launches {want} and no other kernel, got {launched}, "
          f"{by_mode}")
    tol = TOL_STEP_MODE[(model, mode)]
    training_step_vs_plain(label, trainer, per_step, tol["grad"], tol["loss"], tol["rnn"])
    training_times(f"{label} at {mode}", trainer)
    set_precision("highest")
    return {"lstm_train_fwd": launched["lstm_train_fwd"],
            "lstm_train_bwd": launched["lstm_train_bwd"], eval_kernel: launched[eval_kernel]}


def smpl_layer_path(rng) -> tuple:
    """SMPLLayer.fk of one 600-frame sequence at the full mesh on the card,
    with the counts at 0: one LBS launch and no other kernel; the vertices
    equal the CPU layer's within 1e-4, the joints fk_joints'; then vertex
    normals at the full mesh. Returns (the card's layer, the LBS launches)."""
    layer = create_default_smpl_model()
    check(layer.device.type == "cuda", "the SMPL layer is not on the card")
    poses = smooth_random_poses(rng, SMPL_FRAMES, 66, 0.4).astype(np.float32)
    args = (poses[:, 3:], (rng.randn(1, 10) * 0.5).astype(np.float32), poses[:, :3],
            smooth_random_poses(rng, SMPL_FRAMES, 3, 0.5).astype(np.float32))
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        verts, joints = layer.fk(*args)
    torch.cuda.synchronize()
    launched = counts()
    print(f"SMPLLayer.fk main path: {SMPL_FRAMES} frames at the full mesh in one call, launches "
          f"{launched}", flush=True)
    check(launched == expected(lbs=1), f"SMPLLayer.fk: expected 1 LBS launch, got {launched}")
    cpu_layer = SMPLLayer(layer.model, "cpu")
    with torch.no_grad():
        cpu_verts, cpu_joints = cpu_layer.fk(*args)
        joints_only = layer.fk_joints(*args)
        normals = layer.vertex_normals(verts)
        cpu_normals = cpu_layer.vertex_normals(cpu_verts)
        fk_ms = cuda_ms(lambda: layer.fk(*args), warmup=1, reps=5)
        normals_ms = cuda_ms(lambda: layer.vertex_normals(verts), warmup=1, reps=5)
    errs = {"vertices": (verts.cpu() - cpu_verts).abs().max().item(),
            "joints": (joints.cpu() - cpu_joints).abs().max().item(),
            "joints vs fk_joints": (joints - joints_only).abs().max().item(),
            "normals": (normals.cpu() - cpu_normals).abs().max().item()}
    finite = bool(torch.isfinite(verts).all() and torch.isfinite(normals).all())
    print(f"SMPLLayer on the card vs the CPU layer: max abs differences {errs}; shapes "
          f"{tuple(verts.shape)}, {tuple(joints.shape)}, normals {tuple(normals.shape)}; finite "
          f"{finite}; fk {fk_ms:.3f} ms per {SMPL_FRAMES}-frame call "
          f"({SMPL_FRAMES / fk_ms * 1e3:.1f} frames/s), vertex normals {normals_ms:.3f} ms",
          flush=True)
    check(finite and verts.shape == (SMPL_FRAMES, V_FULL, 3) and normals.shape == verts.shape,
          "SMPLLayer outputs are not finite or have wrong shapes")
    check(max(errs["vertices"], errs["joints"], errs["normals"]) <= TOL,
          f"SMPLLayer on the card differs from the CPU layer: {errs}")
    check(errs["joints vs fk_joints"] <= 1e-6, f"fk joints differ from fk_joints: {errs}")
    return layer, launched["lbs"]


def write_raw_corpora(root: str, rng) -> tuple:
    """A seeded AMASS-style npz tree (2 subjects x 2 motions at 120 fps, one
    of 5200 frames; a subject shape file and a denylisted file, both
    skipped) and a 3DPW-style pkl of 2 subjects at 60 Hz."""
    amass = os.path.join(root, "raw", "amass")
    for subj, lengths in (("SubjectA", (5200, 300)), ("SubjectB", (420, 240))):
        d = os.path.join(amass, subj)
        os.makedirs(d)
        for i, nf in enumerate(lengths):
            np.savez(os.path.join(d, f"motion{i}_poses.npz"),
                     poses=smooth_random_poses(rng, nf, 156, 0.3), betas=rng.randn(16),
                     trans=smooth_random_poses(rng, nf, 3, 0.5),
                     mocap_framerate=np.asarray(120.0), gender="neutral")
        np.savez(os.path.join(d, "subject_shape.npz"), betas=rng.randn(16))
    np.savez(os.path.join(amass, "SubjectA", "MTR03_poses.npz"), poses=np.zeros((5, 156)),
             betas=np.zeros(16), trans=np.zeros((5, 3)), mocap_framerate=np.asarray(120.0),
             gender="neutral")
    threedpw = os.path.join(root, "raw", "3dpw")
    os.makedirs(threedpw)
    seq = {"poses_60Hz": [smooth_random_poses(rng, 900, 72, 0.3),
                          smooth_random_poses(rng, 700, 72, 0.3)],
           "betas": [rng.randn(10), rng.randn(10)],
           "trans_60Hz": [smooth_random_poses(rng, 900, 3, 0.5),
                          smooth_random_poses(rng, 700, 3, 0.5)],
           "genders": ["f", "m"]}
    with open(os.path.join(threedpw, "seq1.pkl"), "wb") as f:
        pickle.dump(seq, f)
    return amass, threedpw


def datagen_path(root: str, rng) -> None:
    """Offline datagen through preprocess's main on the card with the counts
    at 0 (joints only: no kernel launch), then on the CPU; the corpora must
    agree record by record."""
    amass, threedpw = write_raw_corpora(root, rng)

    def run(device: str):
        out = os.path.join(root, "datagen", device)
        fk = preprocess.main(["--amass_in", amass, "--amass_out", os.path.join(out, "amass.emr"),
                              "--threedpw_in", threedpw, "--threedpw_out",
                              os.path.join(out, "3dpw.emr"), "--device", device])
        return fk, out

    torch.cuda.synchronize()
    reset_counts()
    fk, out = run("cuda")
    torch.cuda.synchronize()
    launched = counts()
    check(launched == expected(), f"datagen launched a kernel: {launched}")
    cpu_fk, cpu_out = run("cpu")
    worst, n_records, frames = 0.0, 0, []
    for name in ("amass.emr", "3dpw.emr"):
        got, want = EMRReader(os.path.join(out, name)), EMRReader(os.path.join(cpu_out, name))
        check(len(got) == len(want), f"{name}: {len(got)} records against {len(want)} on the CPU")
        for i in range(len(want)):
            check(got.meta(i) == want.meta(i), f"{name} record {i}: metas differ")
            for field in ("poses", "betas", "trans"):
                check(np.array_equal(got.read(i, field), want.read(i, field)),
                      f"{name} record {i}: {field} differ from the CPU run")
            joints = got.read(i, "joints")
            check(np.isfinite(joints).all(), f"{name} record {i}: joints not finite")
            worst = max(worst, float(np.abs(joints - want.read(i, "joints")).max()))
            frames.append(got.meta(i)["n_frames"])
        n_records += len(want)
    print(f"datagen main path: {n_records} records of {frames} frames, launches {launched}; "
          f"joints vs the CPU run max abs {worst:.3e}, poses/betas/trans equal; FK stage "
          f"{fk.frames} frames in {fk.seconds:.3f} s = {fk.frames / fk.seconds:.1f} frames/s on "
          f"the card, {cpu_fk.frames / cpu_fk.seconds:.1f} frames/s on the CPU", flush=True)
    check(n_records == 6 and max(frames) == 2600, f"unexpected corpora: {frames}")
    check(worst <= TOL, f"datagen joints differ from the CPU run: {worst} > {TOL}")


def export_path(root: str, layer: SMPLLayer, rng) -> int:
    """export_visualization of one 1100-frame sequence with the counts at
    0: 3 FK chunks each for GT and prediction, so 6 LBS launches and no
    other kernel; the npz and both OBJ files written. Returns the launches."""
    poses = smooth_random_poses(rng, EXPORT_FRAMES, 66, 0.4).astype(np.float32)
    host_batch = {"seq_lengths": np.array([EXPORT_FRAMES]), "poses": poses[None],
                  "shapes": (rng.randn(1, 10) * 0.5).astype(np.float32)}
    pose_hat = (poses + rng.randn(*poses.shape) * 0.05).astype(np.float32)
    out_dir = os.path.join(root, "visualization")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    npz_path = export_visualization(layer, "seq0000", host_batch, pose_hat,
                                    (rng.randn(10) * 0.5).astype(np.float32), out_dir)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    npz = np.load(npz_path)
    objs = [os.path.join(out_dir, f"seq0000_frame0_{k}.obj") for k in ("gt", "pred")]
    ok = (npz["verts_gt"].shape == (EXPORT_FRAMES, V_FULL, 3)
          and npz["verts_hat"].shape == (EXPORT_FRAMES, V_FULL, 3)
          and npz["joints_hat"].shape == (EXPORT_FRAMES, 22, 3)
          and all(np.isfinite(npz[k]).all() for k in ("verts_gt", "verts_hat", "joints_gt"))
          and all(os.path.getsize(p) > 0 for p in objs))
    print(f"export_visualization main path: {EXPORT_FRAMES} frames, launches {launched}, "
          f"{seconds:.2f} s (compressed npz {os.path.getsize(npz_path) / 2 ** 20:.1f} MiB and "
          f"two OBJ files written: {ok})", flush=True)
    check(launched == expected(lbs=6), f"export: expected 6 LBS launches, got {launched}")
    check(ok, "export_visualization wrote wrong or missing artifacts")
    return launched["lbs"]


def table_diff(a: list, b: list) -> float:
    """Largest |a - b| / max(|b|, 1) over the numbers of two metric tables
    with the same ids (inf where the ids differ)."""
    if [r[0] for r in a] != [r[0] for r in b]:
        return float("inf")
    x, y = np.array([r[1:] for r in a], float), np.array([r[1:] for r in b], float)
    return float((np.abs(x - y) / np.maximum(np.abs(y), 1.0)).max())


def quiet_eval(argv: list) -> tuple:
    """``python -m empose_tpu_torch.eval``'s main with its printout kept:
    (rows, printed text)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows, _ = eval_cli.main(argv)
    return rows, out.getvalue()


def eval_path(label: str, model_id: str, kernel: str, per_forward, window) -> dict:
    """Real-data evaluation of ``model_id`` through ``python -m
    empose_tpu_torch.eval``'s main on the recordings of $EM_DATA_REAL.

    The batched pass runs with the counts at 0: ``kernel`` must launch
    ``per_forward(N)`` times per forward of the pass (one per window of each
    group of N sequences) and no other kernel. The serial pass, the host
    oracle and the batched pass with the plain LSTM versions (no launch)
    must give its table within TOL_EVAL; ``--cross_subject`` gives the
    hold-out row. Then one batched pass timed on the host clock and one
    profiled. Returns the launches and the numbers."""
    argv = ["--model_id", model_id]
    _, _, groups = EH.build_eval_corpus(make_real_loader(), window)
    forwards = [stacked["poses"].shape[0] for _, stacked, w in groups
                for _ in range(stacked["poses"].shape[1] // w)]
    want = sum(per_forward(n) for n in forwards)
    torch.cuda.synchronize()
    reset_counts()
    rows, text = quiet_eval(argv)
    torch.cuda.synchronize()
    launched = counts()
    print(text[text.index("Nr"):].rstrip(), flush=True)
    print(f"{label} eval main path (batched): {len(groups)} groups, {len(forwards)} forwards "
          f"(N = {sorted(set(forwards))}), launches {launched}", flush=True)
    check(launched == expected(**{kernel: want}),
          f"{label} eval: expected {want} {kernel} launches and no other kernel, got {launched}")
    finite = all(np.isfinite(r[1:]).all() for r in rows)
    check(finite and len(rows) == REAL_RECORDINGS + 1 and rows[-1][0] == "Overall average",
          f"{label} eval: the table is not {REAL_RECORDINGS} finite rows and the overall row")

    cross = quiet_eval(argv + ["--cross_subject"])[0]
    check(len(cross) == 2 and all(np.isfinite(r[1:]).all() for r in cross),
          f"{label} eval: --cross_subject did not give the hold-out row and the overall")

    from torch.profiler import ProfilerActivity, profile
    session, loader, _ = EH.load_model_and_eval_data(model_id)
    lengths = [int(b["seq_lengths"][0]) for b in loader]

    def one_pass():
        with contextlib.redirect_stdout(io.StringIO()):
            got = EH.evaluate_real_sequences(session, loader, window)[0]
        torch.cuda.synchronize()
        return got

    diffs = {"serial": table_diff(quiet_eval(argv + ["--serial"])[0], rows),
             "host_metrics": table_diff(quiet_eval(argv + ["--host_metrics"])[0], rows)}
    rnn = session.model.rnn
    rnn.lstm_stack, rnn.lstm_bidi = K.lstm_stack_plain, K.lstm_bidi_plain
    before = counts()
    diffs["plain_lstm"] = table_diff(one_pass(), rows)
    check(counts() == before, f"{label} eval: the plain-LSTM run launched a kernel")
    rnn.lstm_stack, rnn.lstm_bidi = K.lstm_stack_fused, K.lstm_bidi_fused
    print(f"{label} eval: largest relative difference to the batched table {diffs}; "
          f"--cross_subject rows {[r[0] for r in cross]}", flush=True)
    for name, d in diffs.items():
        check(d <= TOL_EVAL, f"{label} eval: the {name} table differs from the batched one by "
                             f"{d} > {TOL_EVAL}")

    one_pass()
    t0 = time.perf_counter()
    one_pass()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        wall_prof = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            / 1e3 for e in dev}
    busy_ms = sum(busy.values())
    ops = sum(e.count for e in dev)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    out = dict(launches=launched[kernel], rows=rows, groups=len(groups), forwards=len(forwards),
               frames=sum(lengths), wall_s=wall, frames_per_s=sum(lengths) / wall,
               wall_profiled_s=wall_prof, busy_ms=busy_ms, busy_share=busy_ms / 1e3 / wall_prof,
               device_ops=ops, diffs=diffs)
    print(f"{label} eval pass (batched, {len(lengths)} recordings, {sum(lengths)} frames): wall "
          f"{wall:.3f} s, {out['frames_per_s']:.0f} frames/s; profiled pass: wall "
          f"{wall_prof:.3f} s, device busy {busy_ms:.1f} ms ({100 * out['busy_share']:.1f}%), "
          f"{ops} device ops, {launched[kernel]} {kernel} launches; largest: "
          + "; ".join(f"{k[:48]} {v:.1f} ms" for k, v in top), flush=True)
    return out


def eval_fit_path(label: str, model_cfg: dict, experiment_id: str, per_step: int,
                  eval_kernel: str, eval_per_forward: int) -> int:
    """3 training steps through the train CLI's main with ``--eval_every 3``:
    one validation and test pass at step 2, which writes the best-test
    checkpoint, then the final passes on it; the training kernels launch
    ``per_step`` times per step and ``eval_kernel`` ``eval_per_forward``
    times per forward of the two rounds of passes. Returns the latter."""
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        model_dir, trainer = train_cli.main(train_flags(model_cfg, experiment_id, 3,
                                                        eval_every=3))
    torch.cuda.synchronize()
    launched = counts()
    text = out.getvalue()
    state = torch.load(os.path.join(model_dir, "checkpoint", "train_state.pt"),
                       map_location="cpu", weights_only=True)
    evals = eval_per_forward * 2 * final_eval_forwards()
    lines = [line for line in text.splitlines()
             if line.startswith(("[VALID", "[TEST", "[VALID FINAL]", "[TEST FINAL]"))]
    print(f"{label} training through an eval boundary: launches {launched}; checkpoint at step "
          f"{state['global_step']}, best test loss {state['best_test_loss']:.6f}; "
          + " | ".join(line[:100] for line in lines), flush=True)
    check(trainer.global_step == 3 and state["global_step"] == 2,
          f"{label}: the eval at step 2 did not write the best-test checkpoint")
    check(sum(line.startswith("[VALID 0") for line in lines) == 1
          and sum(line.startswith("[TEST  ") for line in lines) == 1
          and np.isfinite(state["best_test_loss"]), f"{label}: no eval at step 2")
    check(launched == expected(lstm_train_fwd=3 * per_step, lstm_train_bwd=3 * per_step,
                               **{eval_kernel: evals}),
          f"{label}: expected {3 * per_step} launches of each training kernel and {evals} "
          f"{eval_kernel} launches, got {launched}")
    return launched[eval_kernel]


def noise_batch(rng, n: int, f: int, lengths) -> dict:
    """Sensor inputs of ``n`` entries of ``f`` frames (12 markers) on the CPU."""
    return {"marker_pos": torch.from_numpy(rng.randn(n, f, 36).astype(np.float32)),
            "marker_ori": torch.from_numpy(rng.randn(n, f, 108).astype(np.float32)),
            "marker_nor": torch.from_numpy(rng.randn(n, f, 36).astype(np.float32)),
            "seq_lengths": torch.as_tensor(lengths, dtype=torch.int64)}


@contextlib.contextmanager
def no_sync():
    """Raise on any host-device synchronization inside the block."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def within_5_se(x: torch.Tensor, mean: float, var: float) -> bool:
    return abs(float(x.double().mean()) - mean) <= 5 * (var / x.numel()) ** 0.5


def noise_phase() -> None:
    """The noise functions on the card at the flagship training batch (16
    entries of 64 frames; valid lengths 64, 0, 3 and seeded ones), each made
    and applied under ``torch.cuda.set_sync_debug_mode("error")``: each
    apply equals its CPU apply on the same draws (suppression bit for bit at
    6 and 12 sensors, spherical within TOL_SPHERICAL); then the moments of
    4096 entries' draws on the card: window starts uniform, each candidate
    sensor and each permutation's first K at their frequency (5 standard
    errors), the masked frames exactly the window, every displacement
    within the radius bound."""
    rng = np.random.RandomState(SEED + 19)
    n, f, k = TRAIN_BATCH, TRAIN_WINDOW, 2
    lengths = rng.randint(1, f + 1, n)
    lengths[:3] = (f, 0, 3)
    cpu = noise_batch(rng, n, f, lengths)
    dev = {key: v.cuda() for key, v in cpu.items()}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    readings = {}
    for n_markers in (6, 12):
        fn = NZ.marker_suppression_noise_fn(0.5, k, 0.0, n_markers)
        with no_sync():
            choice, u = NZ.draw_suppression_noise(n, k, n_markers, g, "cuda")
            got = NZ.marker_suppression_noise(dev, choice, u, 0.5, 0.0, n_markers)
            fn(dev, g)
        want = NZ.marker_suppression_noise(cpu, choice.cpu(), u.cpu(), 0.5, 0.0, n_markers)
        equal = all(torch.equal(got[key].cpu(), want[key]) for key in cpu)
        readings[f"suppression n{n_markers}"] = (equal, int((got["marker_pos"] == 0).sum()))
        check(equal, f"suppression noise ({n_markers} sensors): the card's apply differs from "
                     "the CPU's on the same draws")
    fn = NZ.spherical_marker_noise_fn(0.5, 0.5, k)
    with no_sync():
        draws = NZ.draw_spherical_noise(n, f, 12, k, g, "cuda")
        got = NZ.spherical_marker_noise(dev, draws, 0.5, 0.5)
        fn(dev, g)
    want = NZ.spherical_marker_noise(cpu, {key: v.cpu() for key, v in draws.items()}, 0.5, 0.5)
    err = float((got["marker_pos"].cpu() - want["marker_pos"]).abs().max())
    same_gate = torch.equal(got["marker_pos"].cpu() != cpu["marker_pos"],
                            want["marker_pos"] != cpu["marker_pos"])
    readings["spherical"] = (err, same_gate)
    print(f"noise on the card (batch {n} x {f}, K={k}, no synchronization): suppression equal "
          f"bit for bit to the CPU's at 6 and 12 sensors "
          f"{ {key: v for key, v in readings.items() if key != 'spherical'} } (equal, masked "
          f"values); spherical max |card - CPU| {err:.3e}, same gate {same_gate}", flush=True)
    check(err <= TOL_SPHERICAL and same_gate, f"spherical noise: the card's apply is "
                                             f"{err} > {TOL_SPHERICAL} from the CPU's")

    n, f, ws = NOISE_MOMENTS_N, 20, 0.25  # windows of 5 frames, starts 0..15
    batch = noise_batch(np.random.RandomState(SEED + 20), n, f, np.full(n, f))
    batch = {key: v.cuda() for key, v in batch.items()}
    with no_sync():
        choice, u = NZ.draw_suppression_noise(n, k, 6, g, "cuda")
        out = NZ.marker_suppression_noise(batch, choice, u, ws, 0.0, 6)
    masked = (out["marker_pos"].reshape(n, f, 12, 3) == 0).all(-1).cpu()
    frames = masked.any(-1)
    starts = frames.float().argmax(1)
    freqs = [float((choice == c).double().mean()) for c in range(6)]
    supp_ok = (bool((frames.sum(1) == 5).all()) and within_5_se(starts, 7.5, (16 ** 2 - 1) / 12)
               and all(within_5_se((choice == c).cpu(), 1 / 6, 5 / 36) for c in range(6))
               and set(torch.nonzero(masked.any(1))[:, 1].tolist()) <= set(C.S_CONFIG_6))
    pos = torch.zeros(n, f, 12, 3, device="cuda")
    pos[0, f // 2, C.T_TO_IDX_WO_ROOT[C.T_RUL]] = torch.tensor([0.0, 2.0, 0.0])
    sph = {"marker_pos": pos.reshape(n, f, -1), "seq_lengths": batch["seq_lengths"]}
    with no_sync():
        draws = NZ.draw_spherical_noise(n, f, 12, 3, g, "cuda")
        out = NZ.spherical_marker_noise(sph, draws, 0.8, ws)
    disp = (out["marker_pos"] - sph["marker_pos"]).reshape(n, f, 12, 3).cpu()
    chosen = draws["perm"][:3].cpu()
    gate = (disp != 0).any(-1)
    sph_frames = gate.any(-1)
    d = disp[:, :, chosen][sph_frames]
    big_r = 0.8 * 2.0 / 2
    firsts = torch.stack([NZ.draw_spherical_noise(1, 1, 12, 3, g, "cuda")["perm"][:3]
                          for _ in range(2000)]).cpu()
    sph_ok = (float(d.abs().max()) <= big_r and bool((sph_frames.sum(1) == 5).all())
              and within_5_se(sph_frames.float().argmax(1), 7.5, (16 ** 2 - 1) / 12)
              and all(within_5_se(d[..., a].double() ** 2, big_r ** 2 / 3 * w,
                                  float((d[..., a].double() ** 2).var()))
                      for a, w in ((0, 0.25), (1, 0.25), (2, 0.5)))
              and all(within_5_se((firsts == i).any(1), 3 / 12, 0.25 * 0.75)
                      for i in range(12)))
    print(f"noise moments on the card ({n} entries of {f} frames, windows of 5): suppression "
          f"starts mean {float(starts.double().mean()):.4f} (7.5), candidate frequencies "
          f"{[round(x, 4) for x in freqs]} (1/6) {supp_ok}; spherical starts mean "
          f"{float(sph_frames.float().argmax(1).double().mean()):.4f}, largest |component| "
          f"{float(d.abs().max()):.4f} <= R {big_r}, mean z^2 {float((d[..., 2] ** 2).mean()):.5f} "
          f"({big_r ** 2 / 6:.5f}), first-3 frequencies over 2000 permutations "
          f"{[round(float((firsts == i).any(1).double().mean()), 3) for i in range(12)]} (0.25) "
          f"{sph_ok}", flush=True)
    check(supp_ok and sph_ok, "the noise draws on the card are off their moments")


def real_windows(window, data_dir: str = None) -> int:
    """Windows of the serial loop over the recordings of ``data_dir``."""
    return sum(-(-b["poses"].shape[1] // window) for b in make_real_loader(data_dir))


def suppression_eval_path(label: str, model_id: str, clean_rows: list, per_forward: int,
                          window: int) -> int:
    """The eval CLI's main at ``--suppression_length 0.5 --suppression_markers
    2`` with the counts at 0 (the serial loop: ``per_forward`` stack launches
    a window, no other kernel): rows other than the clean ones; then, on the
    hold-out recording (``--cross_subject``, to keep the smoke short), the
    same rows on a second run and the host oracle's within TOL_EVAL.
    Returns the launches of the first run."""
    argv = ["--model_id", model_id, "--suppression_length", "0.5", "--suppression_markers", "2"]
    want = per_forward * real_windows(window)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows, _ = quiet_eval(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    cross, again = (quiet_eval(argv + ["--cross_subject"])[0] for _ in range(2))
    host = quiet_eval(argv + ["--cross_subject", "--host_metrics"])[0]
    shift, host_diff = table_diff(rows, clean_rows), table_diff(host, cross)
    print(f"{label} eval under suppression (length 0.5, 2 sensors; serial): launches "
          f"{launched}, wall {wall:.3f} s; overall {[round(v, 4) for v in rows[-1][1:]]} "
          f"against clean {[round(v, 4) for v in clean_rows[-1][1:]]} (largest relative "
          f"shift {shift:.4f}); hold-out: second run equal {again == cross}, host oracle "
          f"relative difference {host_diff:.3e}", flush=True)
    check(launched == expected(lstm_stack=want),
          f"{label} suppression eval: expected {want} stack launches, got {launched}")
    check(len(rows) == REAL_RECORDINGS + 1 and all(np.isfinite(r[1:]).all() for r in rows),
          f"{label} suppression eval: not {REAL_RECORDINGS} finite rows and the overall")
    check(shift > 0, f"{label} suppression eval: the rows equal the clean rows")
    check(again == cross and len(cross) == 2,
          f"{label} suppression eval: a second hold-out run gave other rows")
    check(host_diff <= TOL_EVAL, f"{label} suppression eval: the host oracle differs by "
                                 f"{host_diff} > {TOL_EVAL}")
    return launched["lstm_stack"]


def study_path(label: str, model_id: str, per_forward: int, window: int, out_dir: str,
               held: bool = False) -> tuple:
    """``python -m empose_tpu_torch.tools.suppression_study``'s main on the
    hold-out recording at lengths 0, 0.5 and markers 1, 2 with the counts at
    0: three rows, three passes of ``per_forward`` stack launches a window;
    the clean row equals the clean eval CLI's overall row (rounded as the
    study rounds). Its monotonicity check is held (exit 0, no violation)
    where ``held`` (trained weights), else printed only (untrained weights
    give no order). Returns the launches and the rows."""
    clean = quiet_eval(["--model_id", model_id, "--cross_subject"])[0][-1]
    out = os.path.join(out_dir, f"study_{model_id}.json")
    want = 3 * per_forward * real_windows(window, os.path.join(os.environ["EM_DATA_REAL"],
                                                               "hold_out"))
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = suppression_study.main(["--model_id", model_id, "--lengths", "0,0.5",
                                     "--markers", "1,2", "--cross_subject", "--out", out])
    torch.cuda.synchronize()
    launched = counts()
    with open(out) as fh:
        result = json.load(fh)
    rows = result["rows"]
    table = text.getvalue()
    print(table[table.index("dropped markers"):].rstrip(), flush=True)
    print(f"{label} suppression study (hold-out, lengths 0, 0.5 x markers 1, 2): exit {rc}, "
          f"launches {launched}; violations ({'held' if held else 'not held: untrained weights'}) "
          f"{result['violations']}", flush=True)
    check([(r["suppression_markers"], r["suppression_length"]) for r in rows]
          == [(0, 0.0), (1, 0.5), (2, 0.5)], f"{label} study: the grid is {rows}")
    check([rows[0][k] for k in METRIC_NAMES] == [round(float(v), 3) for v in clean[1:]],
          f"{label} study: the clean row {rows[0]} is not the eval CLI's overall {clean}")
    check(launched == expected(lstm_stack=want),
          f"{label} study: expected {want} stack launches, got {launched}")
    if held:
        check(rc == 0 and not result["violations"],
              f"{label} study: MPJPE is not monotone: {result['violations']}")
    return launched["lstm_stack"], rows


def remat_path(per_step: int) -> tuple:
    """One LGD-RNN-6 training step with and without ``--remat`` from the same
    state and batch: the loss and every gradient equal bit for bit; the
    memory the graph holds after the forward and the loss, the peak over
    the step, and the step's p50, at batch 16 x window 64 and at windows of
    up to 512 frames (the 3DPW-style corpus). Returns the training pair's
    launches (each must launch ``per_step`` times a step)."""
    fwd = bwd = 0
    flags = train_flags(LGD_RNN_6, "900040", 1)[:-2]  # without --max_steps
    for corpus, window, reps in (("amass_emr", TRAIN_WINDOW, 5), ("3dpw_emr", REMAT_WINDOW, 3)):
        loader = EMRBatchLoader(os.path.join(os.environ["EM_DATA_SYNTH"], corpus), TRAIN_BATCH,
                                window, seed=SEED + 5)
        host_batch = next(iter(loader))
        read = {}
        for remat in (False, True):
            trainer = Trainer(Configuration(vars(Configuration.parser().parse_args(
                flags + (["--remat"] if remat else [])))))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            batch = trainer.pre_train(trainer.upload(host_batch), trainer.generator, mode="all")
            loss, _ = trainer.loss(batch)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()
                     if p.grad is not None}
            del batch
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(host_batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launched = counts()
            check(launched == expected(lstm_train_fwd=per_step * (1 + reps),
                                       lstm_train_bwd=per_step * (1 + reps)),
                  f"remat={remat}: expected {per_step * (1 + reps)} launches of each training "
                  f"kernel, got {launched}")
            fwd, bwd = fwd + launched["lstm_train_fwd"], bwd + launched["lstm_train_bwd"]
            read[remat] = dict(loss=loss.detach(), grads=grads, held=held, peak=peak,
                               p50=float(np.median(times)), total=torch.cuda.max_memory_allocated())
            del trainer, loss
            torch.cuda.empty_cache()
        a, b = read[False], read[True]
        same = torch.equal(a["loss"], b["loss"]) and sorted(a["grads"]) == sorted(b["grads"]) \
            and all(torch.equal(b["grads"][k], g) for k, g in a["grads"].items())
        f = host_batch["poses"].shape[1]
        print(f"--remat, LGD-RNN-6 batch {TRAIN_BATCH} x window {f}: loss and {len(a['grads'])} "
              f"gradients equal bit for bit {same}; held after forward+loss "
              f"{a['held'] / 2 ** 20:.1f} MiB without, {b['held'] / 2 ** 20:.1f} MiB with; "
              f"peak over the step {a['peak'] / 2 ** 20:.1f} MiB without, "
              f"{b['peak'] / 2 ** 20:.1f} MiB with (above the weights; "
              f"max_memory_allocated {a['total'] / 2 ** 20:.1f}, {b['total'] / 2 ** 20:.1f} "
              f"MiB); step p50 {a['p50']:.3f} ms without, {b['p50']:.3f} ms with "
              f"({reps} steps)", flush=True)
        check(same, f"--remat at window {f}: the loss or a gradient differs from the step "
                    "without it")
    return fwd, bwd


def profile_path(per_step: int, eval_per_forward: int, out_dir: str) -> tuple:
    """Two LGD-RNN-6 steps through the train CLI's main with
    ``--profile_dir``: the trace parses as JSON and holds both training
    kernels by name, each launched ``per_step`` times a step (the final
    passes, outside the trace, launch the stack kernel). Returns the
    launches."""
    trace_dir = os.path.join(out_dir, "trace")
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(train_flags(LGD_RNN_6, "900041", 2) + ["--profile_dir", trace_dir])
    torch.cuda.synchronize()
    launched = counts()
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {name: sum(name in k for k in kernels)
             for name in ("lstm_train_fwd_kernel", "lstm_train_bwd_kernel")}
    size = os.path.getsize(os.path.join(trace_dir, files[0]))
    print(f"--profile_dir: {len(files)} trace of {size / 2 ** 20:.1f} MiB, {len(events)} events, "
          f"{len(kernels)} kernel events, training kernels by name {found}; launches {launched}",
          flush=True)
    check(len(files) == 1 and all(v == 2 * per_step for v in found.values()),
          f"--profile_dir: the trace does not hold each training kernel {2 * per_step} times")
    check(launched == expected(lstm_train_fwd=2 * per_step, lstm_train_bwd=2 * per_step,
                               lstm_stack=eval_per_forward * final_eval_forwards()),
          f"--profile_dir run: unexpected launches {launched}")
    return launched["lstm_train_fwd"], launched["lstm_train_bwd"], launched["lstm_stack"]


def bench_path(mode: str = "highest") -> int:
    """The port's bench tool at --batch 1 64 --window 16 --iters 5
    --precision ``mode`` with the counts at 0: each timed call of the stack
    and of the wavefront launches its kernel once, at the mode. Returns the
    wavefront's launches."""
    flags = ["--batch", "1", "64", "--window", "16", "--iters", "5", "--precision", mode]
    torch.cuda.synchronize()
    reset_counts()
    rows = bench_lstm_kernels.main(flags)
    torch.cuda.synchronize()
    launched = counts()
    args = bench_lstm_kernels.parser().parse_args(flags)
    per_kernel = len(args.batch) * (1 + args.repeats * args.iters)
    print(f"bench tool main path ({' '.join(flags)}): {len(rows)} rows, launches {launched}",
          flush=True)
    check(len(rows) == 6 and all(np.isfinite(r[2]) for r in rows), "bench tool rows missing")
    check(launched == expected(lstm_stack=per_kernel, lstm_wavefront=per_kernel)
          and K.MODE_LAUNCHES == {("lstm_stack", mode): per_kernel,
                                  ("lstm_wavefront", mode): per_kernel},
          f"bench tool: expected {per_kernel} stack and wavefront launches at {mode}, got "
          f"{launched}, {K.MODE_LAUNCHES}")
    return launched["lstm_wavefront"]


# ---------------------------------------------------------------------------
# Data parallelism, --steps_per_call, sharded serving, bulk datagen and the
# serving bench.

def dp_config() -> Configuration:
    """LGD-RNN-6 at the flagship window with a global batch of DP_BATCH."""
    return Configuration.from_dict(dict(LGD_RNN_6, window_size=TRAIN_WINDOW, bs_train=DP_BATCH,
                                        seed=SEED))


def steps_with_first_grads(trainer: Trainer, batches: list) -> dict:
    """``multihost_worker.run_steps`` of ``trainer`` on ``batches``, with the
    gradients of the first step (averaged over the ranks in a group), read
    before the second step clears them."""
    first = run_steps(trainer, batches[:1])
    grads = {k: p.grad.detach().cpu().clone() for k, p in trainer.model.named_parameters()
             if p.grad is not None}
    result = run_steps(trainer, batches[1:])
    result["vals"] = first["vals"] + result["vals"]
    result["grads"] = grads
    result["first_state"] = first["state"]
    return result


def dp_rank(rank: int, device, config, seed: int, batches: list, out: str) -> None:
    """One rank of the data-parallel phase (``parallel.mesh.spawn``): its
    steps (``steps_with_first_grads``) and its kernels' launches, to
    ``out % rank``."""
    trainer = Trainer(config, seed=seed, device=device)
    torch.cuda.synchronize()
    reset_counts()
    result = steps_with_first_grads(trainer, batches)
    torch.cuda.synchronize()
    result["counts"] = counts()
    torch.save(result, out % rank)


def same_state(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def dp_training_path(root: str, per_step: int) -> tuple:
    """Two gloo ranks on cuda:0 take DP_STEPS LGD-RNN-6 steps on global
    batches of DP_BATCH (padded to a multiple of 2), held against the same
    steps in this process alone at the CPU test's tolerances (the first
    step's loss values rtol 2e-5, the later steps', after Adam's first
    updates, 2e-4 as in the JAX test; parameters and BatchNorm statistics
    atol 2e-3), the ranks'
    parameters, statistics and generators bit for bit equal; a one-rank
    NCCL group in this process takes the same steps bit for bit equal to
    the single process's; ``--dp_devices`` beyond the card count raises
    ValueError before any step. Returns the training pair's launches, the
    ranks' added up."""
    config = dp_config()
    loader = EMRBatchLoader(os.path.join(os.environ["EM_DATA_SYNTH"], "amass_emr"), DP_BATCH,
                            TRAIN_WINDOW, seed=SEED + 7)
    batches = list(itertools.islice(iter(loader), DP_STEPS))
    for b in batches:
        b.pop("ids")
    check(all(b["poses"].shape[0] == DP_BATCH for b in batches), "short DP batch")
    torch.cuda.synchronize()
    reset_counts()
    single = steps_with_first_grads(Trainer(config, seed=SEED), batches)
    torch.cuda.synchronize()
    single_counts = counts()

    out = os.path.join(root, "dp_rank%d.pt")
    t0 = time.perf_counter()
    spawn(dp_rank, [torch.device("cuda", 0)] * 2, config, SEED, batches, out, backend="gloo")
    ranks = [torch.load(out % r, weights_only=False) for r in range(2)]
    spawn_s = time.perf_counter() - t0
    same_ranks = all(same_state(r["state"], ranks[0]["state"])
                     and torch.equal(r["generator"], ranks[0]["generator"])
                     and r["vals"] == ranks[0]["vals"] for r in ranks[1:])
    loss_err = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w)
                for g, w in zip(ranks[0]["vals"], single["vals"])]
    state_err = max(float((ranks[0]["state"][k].float() - v.float()).abs().max())
                    for k, v in single["state"].items() if v.is_floating_point())
    print(f"DP training: 2 gloo ranks on cuda:0, LGD-RNN-6, {DP_STEPS} steps of a global batch "
          f"of {DP_BATCH} x window {TRAIN_WINDOW} (padded to {-(-DP_BATCH // 2) * 2}) in "
          f"{spawn_s:.1f} s with the ranks' start; ranks bit for bit equal {same_ranks}; against "
          f"one process: largest relative loss difference by step "
          f"{', '.join(f'{e:.3e}' for e in loss_err)} (the first <= 2e-5, the others <= 2e-4), "
          f"largest parameter or statistic difference {state_err:.3e} (<= 2e-3); launches per rank "
          f"{[r['counts'] for r in ranks]}, single process {single_counts}", flush=True)
    # The first step's gradients, the ranks' average against one process's on
    # the same global batch: per tensor against the CPU test's bar
    # (tests/test_torch_parallel.py: 1e-4 x (1 + max |g|), the tiny LGD-RNN),
    # held at full width as the whole-step check holds LGD-RNN-6 (TOL_GRAD_LGD
    # of the largest gradient: what rounding alone moves a step,
    # ``--step-rounding``); the entries of opposite sign (Adam's first update
    # moves each by about lr x sign(g)) and the parameters after step 1.
    g_one, g_dp = single["grads"], ranks[0]["grads"]
    grad_diff = {k: float((g_dp[k] - g).abs().max()) for k, g in g_one.items()}
    cpu_bar = {k: 1e-4 * (1.0 + float(g.abs().max())) for k, g in g_one.items()}
    g_max = max(float(g.abs().max()) for g in g_one.values())
    worst = max(grad_diff, key=lambda k: grad_diff[k] / cpu_bar[k])
    flips = {k: (g_dp[k] * g < 0) for k, g in g_one.items()}
    n_flips = sum(int(f.sum()) for f in flips.values())
    flip_max = max((float(g[flips[k]].abs().max()) for k, g in g_one.items() if flips[k].any()),
                   default=0.0)
    step1_diff = max(float((ranks[0]["first_state"][k].float() - v.float()).abs().max())
                     for k, v in single["first_state"].items() if v.is_floating_point())
    over_cpu_bar = sorted(k for k in grad_diff if grad_diff[k] > cpu_bar[k])
    print(f"DP training, step 1 gradients (2 ranks averaged against one process, "
          f"{len(grad_diff)} tensors): largest difference {max(grad_diff.values()):.3e}, "
          f"{max(grad_diff.values()) / g_max:.3e} of the largest gradient {g_max:.3e} "
          f"(<= {TOL_GRAD_LGD}); against the CPU test's bar 1e-4 x (1 + max |g|) per tensor: "
          f"nearest {worst} {grad_diff[worst]:.3e} against {cpu_bar[worst]:.3e}, "
          f"{len(over_cpu_bar)} tensors over it {over_cpu_bar}; {n_flips} gradient entries of "
          f"opposite sign (largest |g| among them {flip_max:.3e}); parameters and statistics "
          f"after step 1 {step1_diff:.3e} apart (lr {config.lr}); ranks' gradients bit for bit "
          f"equal {all(same_state(r['grads'], g_dp) for r in ranks[1:])}", flush=True)
    check(sorted(g_dp) == sorted(g_one)
          and max(grad_diff.values()) <= TOL_GRAD_LGD * g_max,
          f"DP step-1 gradients differ from one process's by "
          f"{max(grad_diff.values()) / g_max} of the largest gradient > {TOL_GRAD_LGD}")
    check(same_ranks, "DP ranks differ in parameters, BatchNorm statistics or generator")
    check(loss_err[0] <= 2e-5 and max(loss_err) <= 2e-4 and state_err <= 2e-3,
          f"DP steps differ from the single-process steps: {loss_err}, {state_err}")
    for r in ranks:
        check(r["counts"] == expected(lstm_train_fwd=per_step * DP_STEPS,
                                      lstm_train_bwd=per_step * DP_STEPS),
              f"a DP rank's launches: {r['counts']}")

    reset_counts()
    init_distributed("file://" + os.path.join(root, "nccl_rendezvous"), 1, 0, "nccl",
                     torch.device("cuda", 0))
    try:
        one = run_steps(Trainer(config, seed=SEED), batches)
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.synchronize()
    one_counts = counts()
    exact = one["vals"] == single["vals"] and same_state(one["state"], single["state"]) \
        and torch.equal(one["generator"], single["generator"])
    print(f"DP training: a one-rank NCCL group's {DP_STEPS} steps equal the single process's bit "
          f"for bit {exact}; launches {one_counts}", flush=True)
    check(exact, "the one-rank NCCL group's steps differ from the single-process steps")

    n = torch.cuda.device_count() + 1
    try:
        train_cli.main(train_flags(LGD_RNN_6, "900050", 1) + ["--dp_devices", str(n)])
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"--dp_devices {n} on this machine: ValueError {raised!r}", flush=True)
    check(raised is not None and raised.startswith(f"need {n} devices")
          and not glob.glob(os.path.join(os.environ["EM_EXPERIMENTS"], "900050-*")),
          "--dp_devices beyond the card count did not raise ValueError before any step")
    fwd = sum(r["counts"]["lstm_train_fwd"] for r in ranks) + one_counts["lstm_train_fwd"]
    bwd = sum(r["counts"]["lstm_train_bwd"] for r in ranks) + one_counts["lstm_train_bwd"]
    return fwd, bwd


def steps_per_call_path(per_step: int, eval_per_forward: int) -> tuple:
    """The train CLI at ``--steps_per_call`` 8 and 1, SPC_STEPS LGD-RNN-6
    steps at batch SPC_BATCH (8 batches an epoch; the print at each epoch's
    first batch cuts the chunks to 1, 8, 8): the logged losses and the
    checkpoint (weights, Adam, generator) bit for bit equal; each chunk
    timed (synchronized), and the p50 per step of each. Returns the
    kernels' launches."""
    chunk_ms = {}
    step_chunk = Trainer.train_step_chunk

    def timed(self, batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = step_chunk(self, batches)
        torch.cuda.synchronize()
        chunk_ms[k].append(((time.perf_counter() - t0) * 1e3, len(batches)))
        return vals

    runs, launched = {}, []
    Trainer.train_step_chunk = timed
    try:
        for k, eid in ((8, "900051"), (1, "900052")):
            chunk_ms[k] = []
            torch.cuda.synchronize()
            reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                model_dir, _ = train_cli.main(
                    train_flags(LGD_RNN_6, eid, SPC_STEPS)
                    + ["--bs_train", str(SPC_BATCH), "--print_every", "9", "--steps_per_call",
                       str(k)])
            torch.cuda.synchronize()
            launched.append(counts())
            runs[k] = (train_losses(model_dir), torch.load(
                os.path.join(model_dir, "checkpoint", "train_state.pt"), weights_only=True))
    finally:
        Trainer.train_step_chunk = step_chunk
    (l8, s8), (l1, s1) = runs[8], runs[1]
    same = l8 == l1 and sorted(l8) == list(range(1, SPC_STEPS + 1)) \
        and same_state(s8["model"], s1["model"]) and torch.equal(s8["generator"], s1["generator"]) \
        and all(same_state(s8["optimizer"]["state"][i], v)
                for i, v in s1["optimizer"]["state"].items())
    step_ms = {k: [ms / n for ms, n in v[1:]] for k, v in chunk_ms.items()}
    print(f"--steps_per_call: LGD-RNN-6 batch {SPC_BATCH} x window {TRAIN_WINDOW}, {SPC_STEPS} "
          f"steps, chunks { {k: [n for _, n in v] for k, v in chunk_ms.items()} }; losses and "
          f"checkpoint at 8 equal those at 1 bit for bit {same}; p50 per step (after the first "
          f"chunk) {float(np.median(step_ms[8])):.3f} ms at 8, "
          f"{float(np.median(step_ms[1])):.3f} ms at 1; launches {launched}", flush=True)
    check(same, "--steps_per_call 8 does not train as 1 bit for bit")
    check(sorted(n for _, n in chunk_ms[8]) == [1, 8, 8], f"chunks at 8: {chunk_ms[8]}")
    for got in launched:
        check(got == expected(lstm_train_fwd=per_step * SPC_STEPS,
                              lstm_train_bwd=per_step * SPC_STEPS,
                              lstm_stack=eval_per_forward * final_eval_forwards()),
              f"--steps_per_call run: unexpected launches {got}")
    return (sum(g["lstm_train_fwd"] for g in launched), sum(g["lstm_train_bwd"] for g in launched),
            sum(g["lstm_stack"] for g in launched))


def sharded_serving_path(feeds, offsets, served, per_forward: int) -> int:
    """LGD-RNN-6 served to STREAMS streams split over [cuda:0, cuda:0]
    (``MultiStreamPredictor(mesh=...)``, ``serve_rounds``): the stack kernel
    once per shard and forward, the outputs within TOL of the unsharded
    ones; then the batched step's p50. Returns the launches."""
    mesh = [torch.device("cuda", 0)] * 2
    multi = MultiStreamPredictor.from_experiment("900001", n_streams=STREAMS, chunk_size=CHUNK,
                                                 mesh=mesh)
    torch.cuda.synchronize()
    reset_counts()
    got = serve_rounds(multi, feeds, offsets)
    torch.cuda.synchronize()
    launched = counts()
    err = max(max_diff(a, b) for a, b in zip(got, served))
    pos, ori = feeds
    times = []
    for _ in range(20):
        for s in range(STREAMS):
            multi.push(s, pos[s, :CHUNK], ori[s, :CHUNK])
        t0 = time.perf_counter()
        multi.step()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"sharded serving: LGD-RNN-6, {STREAMS} streams over {len(mesh)} shards on cuda:0, "
          f"{len(got)} steps: launches {launched}, max |sharded - unsharded| {err:.3e}; batched "
          f"step p50 {float(np.median(times)):.3f} ms", flush=True)
    check(launched == expected(lstm_stack=2 * per_forward * len(got)),
          f"sharded serving: expected {2 * per_forward * len(got)} stack launches, got {launched}")
    check(err <= TOL, f"sharded serving differs from unsharded: {err} > {TOL}")
    return launched["lstm_stack"]


def bulk_datagen_path(root: str) -> None:
    """``bulk_synthesize`` of the training corpus (windows of 64, batch 32,
    level -1) on the card and on the CPU: the same records (positions,
    joints, poses and the rest within TOL; the sensor orientations and
    normals no farther from float64 frames of the same poses than twice
    the CPU's), no kernel launched; frames/s of each."""
    corpus = os.path.join(os.environ["EM_DATA_SYNTH"], "amass_emr")
    rates, paths = {}, {}
    for device in ("cuda", "cpu"):
        paths[device] = os.path.join(root, f"bulk_{device}.emr")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            n = bulk_synthesize.synthesize_corpus(corpus, paths[device], window=TRAIN_WINDOW,
                                                  batch=32, noise_level=-1, seed=SEED,
                                                  device=device)
        torch.cuda.synchronize()
        rates[device] = n * TRAIN_WINDOW / (time.perf_counter() - t0)
        check(counts() == expected(), f"bulk datagen launched a kernel: {counts()}")
    got, want = EMRReader(paths["cuda"]), EMRReader(paths["cpu"])
    check(len(got) == len(want) == 64, f"bulk datagen wrote {len(got)} and {len(want)} records")
    # The sensor frames against float64 frames of the same poses, shapes and
    # offset rotations: a frame from a thin triangle of the synthetic mesh is
    # ill-conditioned, so the card's float32 frames are held to the CPU's
    # own distance from float64, not to the CPU's frames.
    sensor64 = SensorSMPL(load_smplh(dtype=np.float64)).double()
    frames = ("marker_ori", "marker_nor")
    worst, off64 = {}, {"cuda": {}, "cpu": {}}
    for i in range(len(want)):
        check(got.meta(i) == want.meta(i), f"bulk record {i}: metas differ")
        n_frames = want.meta(i)["n_frames"]
        with torch.no_grad():
            ori = sensor64.markers_and_joints(
                torch.tensor(want.read(i, "poses"), dtype=torch.float64),
                torch.tensor(np.repeat(want.read(i, "betas")[None], n_frames, 0),
                             dtype=torch.float64)
            )[1].reshape(n_frames, -1, 3, 3)
        ori = (ori @ torch.tensor(want.read(i, "offset_r"), dtype=torch.float64)).numpy()
        ref = {"marker_ori": ori.reshape(n_frames, -1),
               "marker_nor": ori[..., 2].reshape(n_frames, -1)}
        for f in want.fields(i):
            a, b = got.read(i, f), want.read(i, f)
            check(np.isfinite(a).all(), f"bulk record {i}: {f} not finite")
            if f in frames:
                for dev, x in (("cuda", a), ("cpu", b)):
                    off64[dev][f] = max(off64[dev].get(f, 0.0), float(np.abs(x - ref[f]).max()))
            else:
                worst[f] = max(worst.get(f, 0.0), float(np.abs(a - b).max()))
    print(f"bulk datagen: {len(want)} windows x {TRAIN_WINDOW} frames at level -1, card against "
          f"CPU max abs by field { {f: float(f'{v:.3e}') for f, v in worst.items()} } (<= {TOL}); "
          f"sensor frames against float64, card "
          f"{ {f: float(f'{v:.3e}') for f, v in off64['cuda'].items()} }, CPU "
          f"{ {f: float(f'{v:.3e}') for f, v in off64['cpu'].items()} } (the card's <= twice the "
          f"CPU's, or {TOL}); {rates['cuda']:.1f} frames/s on the card, {rates['cpu']:.1f} on the "
          "CPU (wall time, the EMR writing included)", flush=True)
    check(all(v <= TOL for v in worst.values()),
          f"bulk datagen on the card differs from the CPU: {worst}")
    check(all(off64["cuda"][f] <= max(2 * off64["cpu"][f], TOL) for f in frames),
          f"bulk datagen's sensor frames on the card lie farther from float64 than the CPU's: "
          f"{off64}")


def bench_serve_path(per_forward: int) -> int:
    """The serving bench (``python -m empose_tpu_torch.tools.bench_serve``'s
    main) at ``--chunk 16 --n 100`` and ``--streams 64 --n 50`` (the tool's
    defaults are 200 and 100; halved for the smoke's time limit): the stack
    kernel once per forward (warm-up included). Returns the launches."""
    total = 0
    for flags in (["--chunk", "16", "--n", "100"], ["--streams", "64", "--n", "50"]):
        torch.cuda.synchronize()
        reset_counts()
        r = bench_serve.main(flags)
        torch.cuda.synchronize()
        launched = counts()
        print(f"bench_serve {' '.join(flags)}: p50 {r['p50']:.3f} ms, p95 {r['p95']:.3f} ms, "
              f"p99 {r['p99']:.3f} ms, max {r['max']:.3f} ms, {r['frames_per_s']:.1f} frames/s; "
              f"launches {launched}", flush=True)
        check(launched == expected(lstm_stack=per_forward * r["forwards"]),
              f"bench_serve: expected {per_forward * r['forwards']} stack launches, got {launched}")
        total += launched["lstm_stack"]
    return total


# ---------------------------------------------------------------------------
# The profilers: the five tools' main functions at their full regimes.

def profiler_stack_checks() -> None:
    """The stack kernel against its plain version at the profilers' shapes
    (PROFILE_STACK_SHAPES)."""
    for f, n in PROFILE_STACK_SHAPES:
        stack_phase(f, n, seed=SEED + f + n, timed=False)


def profiler_pair_checks() -> None:
    """The training pair against its plain versions at the profilers' shapes
    (PROFILE_PAIR_SHAPES)."""
    for f, n in PROFILE_PAIR_SHAPES:
        train_pair_phase(f, n, seed=SEED + f + n + HIDDEN, timed=False)


def tool_run(main, argv: list, **depth) -> tuple:
    """``main(argv, **depth)`` with the counts at 0, its printout echoed:
    (rows, launches by kernel, launches by (kernel, mode))."""
    torch.cuda.synchronize()
    reset_counts()
    rows = quiet_tool(functools.partial(main, **depth), argv)[0]
    torch.cuda.synchronize()
    return rows, counts(), dict(K.MODE_LAUNCHES)


def check_tool_launches(label: str, launched: dict, by_mode: dict, mode: str, **want) -> None:
    """The run launched exactly ``want`` (kernel -> count), all at ``mode``."""
    print(f"{label}: launches {launched}, by mode {by_mode}; expected {want}", flush=True)
    check(launched == expected(**want)
          and by_mode == {(k, mode): v for k, v in want.items() if v},
          f"{label}: expected the launches {want} at {mode} and no other, got {launched}, "
          f"{by_mode}")


def check_floor(label: str, ms, gflop=None) -> None:
    """A time is positive and, with a FLOP count, above the guard's floor
    (the FLOPs at the H100's dense bf16 peak)."""
    floor = gflop * 1e9 / PROFILE.PEAK_BF16_FLOPS * 1e3 if gflop else 0.0
    check(ms is not None and np.isfinite(ms) and ms > floor,
          f"{label}: {ms} ms is not above the floor of {floor:.6f} ms")


def remat_step_bits(per_layer: int, batch: int, window: int) -> tuple:
    """One ``profile_common.make_train_step`` step of LGD-RNN-6 at ``batch`` x
    ``window`` with and without ``--remat``, from the same weights, batch and
    generator: the loss and every gradient equal bit for bit. Then the host
    share of the step without ``--remat``, on that batch: the step timed
    without the profiler (``timeit_ms`` at PROFILE_DEPTH), then
    ``profile_window`` over 3 steps, and its device busy time against the
    unprofiled step. Returns the training pair's launches and the step's
    unprofiled ms."""
    host = PROFILE.tiny_batch(np.random.RandomState(SEED), n=batch, f=window)
    read = {}
    torch.cuda.synchronize()
    reset_counts()
    for remat in (True, False):
        config = PROFILE.flagship_config()
        config.bs_train, config.window_size, config.remat = batch, window, remat
        model, sensor = PROFILE.build_model(config, "cuda")
        step, _ = PROFILE.make_train_step(model, sensor, config)
        data = to_device(host, "cuda")
        generator = torch.Generator("cuda").manual_seed(SEED)
        vals = step(data, generator)
        read[remat] = (vals["total_loss"],
                       {k: p.grad.clone() for k, p in model.named_parameters()})
    (loss_r, grads_r), (loss, grads) = read[True], read[False]
    same = torch.equal(loss, loss_r) and sorted(grads) == sorted(grads_r) \
        and all(torch.equal(grads_r[k], g) for k, g in grads.items())
    print(f"profilers, --remat at {batch} x {window}: loss {float(loss):.6f} and {len(grads)} "
          f"gradients equal bit for bit {same}", flush=True)
    check(same, f"--remat at {batch} x {window}: the loss or a gradient differs from the step "
                "without it")
    step_ms = timeit_ms(step, data, generator, **PROFILE_DEPTH)
    busy = profile_window(f"LGD-RNN-6 train step {batch} x {window} "
                          "(profile_common.make_train_step)", lambda: step(data, generator), 3)
    print(f"host share, LGD-RNN-6 train step {batch} x {window}: device busy {busy:.3f} ms of the "
          f"{step_ms:.3f} ms step without the profiler (the same step and batch, best of "
          f"{PROFILE_DEPTH['repeats']} blocks of {PROFILE_DEPTH['iters']}): busy "
          f"{100 * busy / step_ms:.1f}%, device idle {100 * (1 - busy / step_ms):.1f}%",
          flush=True)
    torch.cuda.synchronize()
    steps = 2 + chain_calls(**PROFILE_DEPTH) + 3
    launched = counts()
    check(launched == expected(lstm_train_fwd=per_layer * steps,
                               lstm_train_bwd=per_layer * steps),
          f"--remat bits and host share: expected {per_layer * steps} launches of each training "
          f"kernel, got {launched}")
    return launched["lstm_train_fwd"], launched["lstm_train_bwd"], step_ms


def loader_draw_ms(batch: int, window: int, draws: int = 5) -> float:
    """Median wall ms of one ``EMRBatchLoader`` batch of ``batch`` windows of
    ``window`` frames from the smoke's training corpus (64 sequences of
    150-300 frames: a batch is one epoch, a shuffle and a crop each)."""
    loader = EMRBatchLoader(os.path.join(os.environ["EM_DATA_SYNTH"], "amass_emr"), batch,
                            window, seed=SEED)
    times = []
    for _ in range(draws + 1):
        t0 = time.perf_counter()
        b = next(iter(loader))
        times.append((time.perf_counter() - t0) * 1e3)
    check(b["poses"].shape[0] == batch, f"the loader drew {b['poses'].shape[0]} windows")
    return float(np.median(times[1:]))


def profilers_path(per_layer: int, stack_per_forward: int) -> dict:
    """The five tools at their full regimes, depth cut (PROFILE_DEPTH): each
    run with the counts at 0 and exactly the launches its stages' calls
    give (a row's ``calls``): per call, the full eval forward and the init
    RNN launch the stack ``stack_per_forward`` times; a train forward
    launches the training forward sweep once per LSTM layer, a gradient
    through it the reverse sweep once per layer; FK, MLPs, datagen and Adam
    launch nothing. Every time above the guard's floor; the remat step bit
    for bit and its memory no larger; the host share of the step; one
    loader draw. Returns the launches: ``highest`` by kernel and ``default``
    by kernel."""
    b, w = PROFILE_TRAIN
    d = dict(PROFILE_DEPTH)
    total = dict.fromkeys(counts(), 0)
    default = dict.fromkeys(("lstm_train_fwd", "lstm_train_bwd"), 0)

    def add(launched):
        for k, v in launched.items():
            total[k] += v

    rows, launched, by_mode = tool_run(profile_fk.main, ["--rows", str(PROFILE_FK_ROWS)],
                                       iters=d["iters"], warmup=d["warmup"])
    check_tool_launches("profile_fk", launched, by_mode, "highest")
    for name, row in rows.items():
        check_floor(f"profile_fk {name}", row["ms"])

    n, f = PROFILE_FORWARD
    rows, launched, by_mode = tool_run(profile_forward.main, ["--batch", str(n), "--window",
                                                              str(f)],
                                       iters=d["iters"], warmup=d["warmup"])
    calls = rows["full forward"]["calls"] + rows["init RNN + heads"]["calls"]
    check_tool_launches("profile_forward", launched, by_mode, "highest",
                        lstm_stack=stack_per_forward * calls)
    add(launched)
    for name, row in rows.items():
        if name != "iter-MLP unfused":
            check_floor(f"profile_forward {name}", row["ms"])

    step_ms = {}
    for remat in (False, True):
        argv = ["--batch", str(b), "--window", str(w)] + (["--remat"] if remat else [])
        rows, launched, by_mode = tool_run(profile_train.main, argv, **d)
        fwd_calls = sum(rows[s]["calls"] for s in ("forward + loss", "forward + backward (grad)",
                                                   "FULL fused step"))
        bwd_calls = sum(rows[s]["calls"] for s in ("forward + backward (grad)",
                                                   "FULL fused step"))
        extra = rows["adam update"]["grad_calls"]
        check_tool_launches(f"profile_train remat={remat}", launched, by_mode, "highest",
                            lstm_train_fwd=per_layer * (fwd_calls + extra),
                            lstm_train_bwd=per_layer * (bwd_calls + extra))
        add(launched)
        for name, row in rows.items():
            check_floor(f"profile_train {name}", row["ms"])
        step_ms[remat] = rows["FULL fused step"]["ms"]

    full_gflop = None
    for mode in PROFILE_MODES:
        rows, launched, by_mode = tool_run(profile_backward.main, ["--batch", str(b), "--window",
                                                                   str(w), "--precision", mode],
                                           **d)
        fwd_calls = sum(rows[r]["calls"] for r in ("init LSTM fwd", "init LSTM fwd+grad",
                                                   "FULL model fwd+loss", "FULL model fwd+grad"))
        bwd_calls = sum(rows[r]["calls"] for r in ("init LSTM fwd+grad", "FULL model fwd+grad"))
        check_tool_launches(f"profile_backward at {mode}", launched, by_mode, mode,
                            lstm_train_fwd=per_layer * fwd_calls,
                            lstm_train_bwd=per_layer * bwd_calls)
        for name, row in rows.items():
            check(row.get("gflop") is not None, f"profile_backward {name}: no FLOP count")
            check_floor(f"profile_backward {name} at {mode}", row["ms"], row["gflop"])
        if mode == "highest":
            add(launched)
            full_gflop = rows["FULL model fwd+grad"]["gflop"]
        else:
            for k in default:
                default[k] += launched[k]
    for remat, ms in step_ms.items():
        check_floor(f"profile_train FULL fused step remat={remat}", ms, full_gflop)

    rows, launched, by_mode = tool_run(measure_remat.main, ["--regimes", ",".join(REMAT_REGIMES),
                                                            "--iters", str(d["iters"])],
                                       warmup=d["warmup"], repeats=d["repeats"])
    steps = sum(r["steps"] for r in rows)
    check_tool_launches("measure_remat", launched, by_mode, "highest",
                        lstm_train_fwd=per_layer * steps, lstm_train_bwd=per_layer * steps)
    add(launched)
    for spec in REMAT_REGIMES:
        bs, win = (int(x) for x in spec.split("x"))
        run = {r["remat"]: r for r in rows if (r["bs"], r["window"]) == (bs, win)}
        mem = {k: r["memory"] for k, r in run.items()}
        print(f"measure_remat {spec}: step {run[False]['step_ms']} -> {run[True]['step_ms']} ms "
              f"(medians {run[False]['step_ms_median']} -> {run[True]['step_ms_median']}); "
              f"temp {mem[False]['temp_mb']} -> {mem[True]['temp_mb']} MiB with --remat "
              f"({100 * (mem[True]['temp_mb'] / mem[False]['temp_mb'] - 1):+.1f}%); "
              f"argument {mem[False]['argument_mb']} MiB, output {mem[False]['output_mb']} MiB",
              flush=True)
        check(mem[True]["temp_mb"] <= mem[False]["temp_mb"],
              f"measure_remat {spec}: --remat holds more ({mem[True]['temp_mb']} MiB) than "
              f"without ({mem[False]['temp_mb']} MiB)")
        for r in run.values():
            check(r["flops_per_frame"] is not None and r["flops_per_frame"] > 0,
                  f"measure_remat {spec} remat={r['remat']}: no FLOP count, so no guard floor")
            check_floor(f"measure_remat {spec} remat={r['remat']}", r["step_ms"],
                        r["flops_per_frame"] * bs * win / 1e9)

    fwd, bwd, host_step_ms = remat_step_bits(per_layer, b, w)
    total["lstm_train_fwd"] += fwd
    total["lstm_train_bwd"] += bwd
    draw = loader_draw_ms(b, w)
    print(f"EMRBatchLoader, one draw of {b} x {w}: {draw:.3f} ms (median of 5) against the step's "
          f"{host_step_ms:.3f} ms ({100 * draw / host_step_ms:.2f}%; profile_train's step "
          f"{step_ms[False]:.3f} ms)", flush=True)
    return {"highest": total, "default": default}


# ---------------------------------------------------------------------------
# The asset writer and the training gates, on a tree of their own.

def gate_tree_path(gate_root: str) -> str:
    """``make_synthetic_assets.generate_all`` of the gates' tree (GATE_TREE)
    on the card and on the CPU, each timed: the same files, npz keys, dtypes
    and shapes; every array the draws alone decide (the model, poses,
    shapes, translations, masks, offsets, the corpora's poses, betas, trans
    and meta) bit for bit; the corpora's FK joints within TOL_FK; the
    sensor fields, float32 frames from vertices a centimetre apart on a
    metre-scale mesh, held against float64 sensors of the same poses: a
    field's largest distance over a recording, the card's at most TOL_FK
    plus twice the CPU's (per marker, the ratio is printed). The writer's FK
    launches no kernel. Returns the card's tree."""
    card, cpu = os.path.join(gate_root, "gate_assets"), os.path.join(gate_root, "gate_assets_cpu")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_assets.generate_all(card, **GATE_TREE)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_assets.generate_all(cpu, device="cpu", **GATE_TREE)
    cpu_s = time.perf_counter() - t0

    def files(root):
        return sorted(os.path.relpath(f, root) for f in glob.glob(os.path.join(root, "**"),
                                                                  recursive=True))

    check(files(card) == files(cpu), "the card's tree and the CPU's hold other files")
    sensor_keys = ("sensor_pos", "sensor_oris")
    n_exact, sensor_ratio, marker_ratio, sensor_far, joints_err = 0, 0.0, 0.0, 0.0, 0.0
    for rel in files(cpu):
        if rel.endswith(".npz"):
            a, b = np.load(os.path.join(card, rel)), np.load(os.path.join(cpu, rel))
            check(sorted(a.files) == sorted(b.files), f"{rel}: other npz keys")
            for k in b.files:
                check((a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), f"{rel} {k}: dtype")
                if k not in sensor_keys:
                    check(np.array_equal(a[k], b[k]), f"{rel} {k}: not bit for bit the CPU's")
                    n_exact += 1
            if "sensor_pos" in b.files:
                ref = make_synthetic_assets.sensors_in_float64(cpu, rel, GATE_TREE["seed"])
                for k, r64 in zip(sensor_keys, ref):
                    f = r64.shape[0]
                    d_card, d_cpu = (np.abs(t[k].reshape(f, 12, -1) - r64).max(axis=(0, 2))
                                     for t in (a, b))
                    sensor_ratio = max(sensor_ratio, float(d_card.max()
                                                           / (TOL_FK + 2 * d_cpu.max())))
                    marker_ratio = max(marker_ratio, float((d_card / (TOL_FK + 2 * d_cpu)).max()))
                    sensor_far = max(sensor_far, float(d_card.max()), float(d_cpu.max()))
        elif rel.endswith(".emr"):
            ra, rb = EMRReader(os.path.join(card, rel)), EMRReader(os.path.join(cpu, rel))
            check([ra.meta(i) for i in range(len(ra))] == [rb.meta(i) for i in range(len(rb))],
                  f"{rel}: other meta")
            for i in range(len(rb)):
                check(ra.fields(i) == rb.fields(i), f"{rel} {i}: other fields")
                for fld in ("poses", "betas", "trans"):
                    check(np.array_equal(ra.read(i, fld), rb.read(i, fld)),
                          f"{rel} {i} {fld}: not bit for bit the CPU's")
                    n_exact += 1
                joints_err = max(joints_err, float(np.abs(ra.read(i, "joints")
                                                          - rb.read(i, "joints")).max()))
    print(f"asset writer (gates' tree: {GATE_TREE}): card {card_s:.3f} s, CPU {cpu_s:.3f} s; "
          f"launches {launched}; {n_exact} draw-only arrays bit for bit; corpus joints card vs "
          f"CPU {joints_err:.3e} (<= {TOL_FK}); sensor fields against float64 (largest distance "
          f"{sensor_far:.3e}): a recording's card distance over ({TOL_FK} + 2 x the CPU's) at "
          f"most {sensor_ratio:.3f} (<= 1), per marker {marker_ratio:.3f}", flush=True)
    check(launched == expected(), f"the asset writer launched a kernel: {launched}")
    check(joints_err <= TOL_FK, f"corpus joints card vs CPU {joints_err} > {TOL_FK}")
    check(sensor_ratio <= 1.0, f"card sensor fields farther from float64 than the CPU's allow: "
                               f"{sensor_ratio}")
    return card


def quiet_tool(main, argv: list) -> tuple:
    """A tool's ``main(argv)`` with its printout kept and echoed: (return
    value, printed text, its last line as JSON or None)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ret = main(argv)
    text = out.getvalue()
    print(text.rstrip(), flush=True)
    last = text.strip().splitlines()[-1] if text.strip() else ""
    return ret, text, json.loads(last) if last.startswith("{") else None


def gate_path(tree: str, per_step: int, stack_per_forward: int) -> tuple:
    """``python -m empose_tpu_torch.tools.convergence_gate``'s main at its
    defaults (GATE_STEPS steps at highest, a kill/resume of GATE_RESUME_K +
    GATE_RESUME_K against 2 x GATE_RESUME_K) on ``tree`` with the counts at
    0: exit 0; untrained MPJPE above MPJPE_START_MIN, trained below
    MPJPE_END_MAX, the loss falls (the gate's own checks); the post-resume
    loss difference 0.0; the training pair ``per_step`` times a step, the
    stack ``stack_per_forward`` times a window of the two MPJPE passes, no
    other kernel. Returns the launches."""
    steps = GATE_STEPS + 4 * GATE_RESUME_K
    windows = 2 * real_windows(256, os.path.join(tree, "data_real"))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rc, text, result = quiet_tool(convergence_gate.main, ["--assets", tree])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    set_precision("highest")
    stats = json.loads(next(line for line in text.splitlines() if line.startswith("step times"))
                       .split(": ", 1)[1])
    print(f"convergence gate (LGD-RNN-6 retrain, batch 12 x window 32, {GATE_STEPS} steps at "
          f"highest): exit {rc}; MPJPE {result['mpjpe_before_mm']} -> {result['mpjpe_after_mm']} "
          f"mm (> {convergence_gate.MPJPE_START_MIN}, < {convergence_gate.MPJPE_END_MAX}); "
          f"post-resume loss difference {result['resume_max_loss_diff']}; s/step mean "
          f"{stats['mean']:.4f}, p25 {stats['p25']:.4f}, median {stats['median']:.4f}, p75 "
          f"{stats['p75']:.4f} ({stats['n']} steps); phase {wall:.1f} s; launches {launched}",
          flush=True)
    check(rc == 0 and result["ok"] and not result["failures"],
          f"the convergence gate failed: {result['failures']}")
    check(result["mpjpe_before_mm"] > convergence_gate.MPJPE_START_MIN
          and result["mpjpe_after_mm"] < convergence_gate.MPJPE_END_MAX,
          f"gate MPJPE {result['mpjpe_before_mm']} -> {result['mpjpe_after_mm']}")
    check(result["resume_max_loss_diff"] == 0.0,
          f"the gate's resume is not bit for bit: {result['resume_max_loss_diff']}")
    want = expected(lstm_train_fwd=per_step * steps, lstm_train_bwd=per_step * steps,
                    lstm_stack=stack_per_forward * windows)
    check(launched == want, f"convergence gate: expected launches {want}, got {launched}")
    return launched


def trained_study_path(tree: str, gate_root: str, per_forward: int) -> int:
    """The suppression study (``study_path``, its monotonicity held) of the
    gate's trained model 920000 on ``tree``'s hold-out recording, and the
    gate's own MPJPE pass (``Trainer.evaluate_test`` at windows of 256) of
    the restored trainer on the same recording: the study's clean row
    equals it (the study rounds to 3 decimals). Returns the stack's
    launches of both."""
    with asset_env(tree):
        launches, rows = study_path("LGD-RNN-6 trained by the gate (920000)", "920000",
                                    per_forward, 256, gate_root, held=True)
        hold_out = os.path.join(os.environ["EM_DATA_REAL"], "hold_out")
        trainer = Trainer(lgd_retrain_config())
        trainer.restore(glob.glob(os.path.join(os.environ["EM_EXPERIMENTS"], "920000-*"))[0])
        torch.cuda.synchronize()
        reset_counts()
        mpjpe = held_out_mpjpe(trainer, MetricsEngine(trainer.smplh, trainer.device),
                               make_real_loader(hold_out), 256)
        torch.cuda.synchronize()
        launched = counts()
        want = per_forward * real_windows(256, hold_out)
    print(f"gate model 920000 on the hold-out recording: the gate's pass {mpjpe:.4f} mm, the "
          f"study's clean row {rows[0]['MPJPE [mm]']} mm; launches {launched}", flush=True)
    check(abs(rows[0]["MPJPE [mm]"] - mpjpe) <= 1e-3,
          f"the study's clean row {rows[0]['MPJPE [mm]']} is not the gate's pass {mpjpe}")
    check(launched == expected(lstm_stack=want), f"the gate's pass: launches {launched}")
    return launches + launched["lstm_stack"]


def demo_convergence_path(tree: str) -> dict:
    """``python -m empose_tpu_torch.tools.demo_convergence``'s main at
    DEMO_STEPS steps on ``tree`` with the counts at 0: the held-out MPJPE
    falls; the training pair once per direction-layer and step, the
    bidirectional layer kernel at H=128 per layer of each whole-sequence
    forward of the two MPJPE passes, no other kernel. Returns the launches."""
    cfg = demo_convergence.birnn_config()
    per_step = 2 * cfg.m_num_layers
    forwards = 2 * len(make_real_loader(os.path.join(tree, "data_real")))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r, _, _ = quiet_tool(demo_convergence.main, ["--assets", tree, "--steps", str(DEMO_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    print(f"demo_convergence (BiRNN 2x{cfg.m_hidden_size}, batch 16 x window 32, {r['steps']} "
          f"steps): MPJPE {r['mpjpe_before_mm']:.2f} -> {r['mpjpe_after_mm']:.2f} mm; training "
          f"{r['train_s']:.3f} s ({1e3 * r['train_s'] / r['steps']:.2f} ms per step); phase "
          f"{wall:.1f} s; launches {launched}", flush=True)
    check(r["mpjpe_after_mm"] < r["mpjpe_before_mm"],
          f"demo_convergence: MPJPE did not fall: {r['mpjpe_before_mm']} -> {r['mpjpe_after_mm']}")
    want = expected(lstm_train_fwd=per_step * r["steps"], lstm_train_bwd=per_step * r["steps"],
                    lstm_bidi=forwards * cfg.m_num_layers * bidi_layer_launches(1, DEMO_HIDDEN))
    check(launched == want, f"demo_convergence: expected launches {want}, got {launched}")
    return launched


def demo_resume_path(tree: str, per_step: int, stack_per_forward: int) -> dict:
    """``python -m empose_tpu_torch.tools.demo_resume``'s main at K =
    DEMO_RESUME_K on ``tree`` with the counts at 0: exit 0, the pre-checkpoint
    and post-resume loss differences 0.0; the training pair ``per_step``
    times a step of its 4K, the stack once per forward of the validation
    pass and per window of the test pass, no other kernel. Returns the
    launches."""
    k = DEMO_RESUME_K
    valid = -(-len(EMRReader(os.path.join(tree, "data_synth", "3dpw_emr", "corpus.emr"))) // 6)
    forwards = valid + real_windows(256, os.path.join(tree, "data_real"))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rc, _, r = quiet_tool(demo_resume.main, ["--assets", tree, "--k", str(k)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    print(f"demo_resume (K={k}): exit {rc}; pre-checkpoint {r['pre_checkpoint_max_loss_diff']}, "
          f"post-resume {r['post_resume_max_loss_diff']}; step median {r['step_s']['median']:.4f}"
          f" s, valid pass {r['valid_pass_s']:.3f} s, test pass {r['test_pass_s']:.3f} s; phase "
          f"{wall:.1f} s; launches {launched}", flush=True)
    check(rc == 0 and r["pre_checkpoint_max_loss_diff"] == 0.0
          and r["post_resume_max_loss_diff"] == 0.0,
          f"demo_resume: the resume is not bit for bit: {r}")
    want = expected(lstm_train_fwd=per_step * 4 * k, lstm_train_bwd=per_step * 4 * k,
                    lstm_stack=stack_per_forward * forwards)
    check(launched == want, f"demo_resume: expected launches {want}, got {launched}")
    return launched


def gates_path(per_step: int, stack_per_forward: int, laps: Laps) -> dict:
    """The asset writer and the three gates on a tree of their own (the tools
    point the four environment variables at it while they run and restore
    them after): the gates' launches added up. The smoke's own tree stays
    behind the variables: checked after."""
    env = {k: os.environ[k] for k in ("SMPL_MODELS", "EM_DATA_REAL", "EM_DATA_SYNTH",
                                      "EM_EXPERIMENTS")}
    total = dict.fromkeys(counts(), 0)
    laps.lap("before the gates")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as gate_root:
        tree = gate_tree_path(gate_root)
        laps.lap("asset writer, card and CPU")
        runs = [gate_path(tree, per_step, stack_per_forward)]
        laps.lap("convergence gate")
        total["lstm_stack"] += trained_study_path(tree, gate_root, stack_per_forward)
        laps.lap("suppression study of the gate's model")
        runs.append(demo_convergence_path(tree))
        laps.lap("demo_convergence")
        runs.append(demo_resume_path(tree, per_step, stack_per_forward))
        laps.lap("demo_resume")
    for run in runs:
        for k, v in run.items():
            total[k] += v
    restored = {k: os.environ.get(k) for k in env} == env
    n_real = len(make_real_loader())
    print(f"after the gates: the smoke's own tree behind the environment {restored}, "
          f"{n_real} real recordings read", flush=True)
    check(restored and n_real == REAL_RECORDINGS,
          "the gates left the environment pointing elsewhere than the smoke's tree")
    return total


# ---------------------------------------------------------------------------
# The high and default precision modes: the stack, wavefront and bidi
# kernels' tensor-core branches against their plain versions at the same
# mode, the served models and the eval CLI at each mode.

def graph_replays(fn, args, fresh: dict) -> bool:
    """``fn(*args)`` captured once in a CUDA graph, replayed after copying
    ``fresh`` {arg index: tensor} into the captured inputs: equal to the
    eager call on them, bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for i, t in fresh.items():
        args[i].copy_(t)
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(out, fn(*args)))


def mode_bound_ms(flops: float, n_bytes: float, mode: str) -> tuple:
    """The larger of the bf16 tensor-core time of the mode's products (3
    passes at HIGH) and the memory time, and which it is."""
    t_ops = flops * (3 if mode == "high" else 1) / BF16_PEAK * 1e3
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stack_mode_bound_ms(f: int, n: int, mode: str, h: int = HIDDEN, layers: int = LAYERS):
    h4 = 4 * h
    flops = 2.0 * f * n * h * h4 * (2 * layers - 1)
    n_bytes = 4.0 * (f * n * h4 + f * n + (2 * layers - 1) * h * h4 + (layers - 1) * h4
                     + 2 * layers * n * h + f * n * h + 2 * layers * n * h)
    return mode_bound_ms(flops, n_bytes, mode)


def bidi_mode_bound_ms(f: int, n: int, mode: str, h: int = HIDDEN):
    h4 = 4 * h
    flops = 2.0 * 2 * f * n * h * h4
    n_bytes = 4.0 * (2 * f * n * h4 + f * n + 2 * h * h4 + 4 * n * h + 2 * f * n * h + 4 * n * h)
    return mode_bound_ms(flops, n_bytes, mode)


def mode_check(name: str, kernel: str, shape: str, mode: str, fused, plain, args, idle,
               h0, c0, fresh: dict, launches_per_call: int) -> float:
    """One kernel at ``mode`` against its plain version at the same mode
    (at high also closer to it than to the plain version at highest): its
    launches, 0-length rows frozen bit for bit, a second call and a
    CUDA-graph replay bit for bit; returns the largest error."""
    key = (kernel, mode)
    before = K.MODE_LAUNCHES.get(key, 0)
    got = fused(*args, mode)
    again = fused(*args, mode)
    launched = K.MODE_LAUNCHES.get(key, 0) - before
    want = plain(*args, mode)
    torch.cuda.synchronize()
    err = max_err(got, want)
    frozen = bool((got[1][:, idle] == h0[:, idle]).all() and (got[2][:, idle] == c0[:, idle]).all())
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    gap = max_err(got, plain(*args, "highest")) if mode == "high" else None
    replay = graph_replays(lambda *a: fused(*a, mode), list(args), fresh)
    tol = TOL_MODE[mode]
    print(f"mode {mode} {name} {shape}: max_abs_err vs its plain version at {mode} {err:.3e} "
          f"(tolerance {tol:g})" + ("" if gap is None else f", vs it at highest {gap:.3e}")
          + f"; 0-length rows ({int(idle.sum())}) frozen bit for bit: {frozen}; "
          f"second call bit for bit: {repeat}; CUDA-graph replay bit for bit: {replay}; "
          f"{launched} launches for 2 calls", flush=True)
    check(launched == 2 * launches_per_call,
          f"{name} at {shape} {mode}: {launched} launches for 2 calls")
    check(err <= tol, f"{name} at {mode} disagrees with its plain version at {shape}: {err} > {tol}")
    check(gap is None or err < gap, f"{name} at {mode} lies no closer to its plain version at "
                                    f"{mode} than at highest at {shape}: {err} >= {gap}")
    check(frozen, f"{name} at {mode} changed the state of 0-length rows at {shape}")
    check(repeat, f"two {name} calls at {mode} differ at {shape}")
    check(replay, f"{name} at {mode}: the CUDA-graph replay differs at {shape}")
    return err


def stack_mode_phase(f: int, n: int, mode: str, seed: int, h: int = HIDDEN,
                     layers: int = LAYERS, timed: bool = True, wavefront: bool = True) -> dict:
    """The stack kernel and (from 2 layers, with ``wavefront``) its
    wavefront schedule at ``mode`` (``mode_check``), each with its launch
    plan; when ``timed``, median times beside the plain versions at the
    mode and cuDNN's LSTM in bf16 (a yardstick: its outputs are bf16), and
    the bound at the bf16 tensor-core rate. Returns both rows."""
    cells, x, mask, h0, c0 = stack_case(f, n, seed, h, layers)
    ops = K.stack_operands(cells, x, mode)
    args = (ops[0], mask, ops[1], ops[2], ops[3], h0, c0)
    idle = mask.sum(0) == 0
    shape = f"F={f} N={n}" + ("" if (h, layers) == (HIDDEN, LAYERS) else f" {layers}x{h}")
    lim = K.stack_limits(x.device)
    fresh = {0: torch.randn_like(ops[0]) * 0.5, 5: torch.randn_like(h0) * 0.5}
    out = {}
    for name, kernel, fused, plain, wave in (
            ("stack kernel", "lstm_stack", K.lstm_stack_fused, K.lstm_stack_plain, False),
            ("wavefront kernel", "lstm_wavefront", K.lstm_stack_wavefront_fused,
             K.lstm_stack_wavefront_plain, True)):
        if wave and (layers < 2 or not wavefront):
            continue
        plan = K.lstm_stack_plan(layers, n, h, *lim, wavefront=wave, precision=mode)
        print(f"mode {mode} {name} launch plan {shape}: {plan._asdict()}", flush=True)
        err = mode_check(name, kernel, shape, mode, fused, plain, args, idle, h0, c0, fresh, 1)
        out[kernel] = dict(max_abs_err=err)
        if timed:
            with torch.no_grad():
                ms = cuda_ms(lambda: fused(*args, mode))
                plain_ms = cuda_ms(lambda: plain(*args, mode), reps=5 if f > 64 else 15)
            out[kernel].update(ms=ms, plain_ms=plain_ms)
    if not timed:
        return out
    lstm = cudnn_stack(cells, h).bfloat16()
    xb, h0b, c0b = x.bfloat16(), h0.bfloat16(), c0.bfloat16()
    with torch.no_grad():
        library_ms = cuda_ms(lambda: lstm(xb, (h0b, c0b)))
    b_ms, b_by = stack_mode_bound_ms(f, n, mode, h, layers)
    for kernel, row in out.items():
        row.update(bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        print(f"mode {mode} times {kernel} {shape}: kernel {row['ms']:.4f} ms "
              f"({row['ms'] * 1e3 / (f * layers):.2f} us per (step, layer)), plain at {mode} "
              f"{row['plain_ms']:.4f} ms, torch.nn.LSTM in bf16 (cuDNN) {library_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by} (bf16 tensor cores)", flush=True)
    return out


def bidi_mode_inputs(f: int, n: int, mode: str, seed: int, h: int = HIDDEN):
    """``bidi_inputs`` with the input projections at ``mode``: ((cells, x,
    lengths), the kernel's operands)."""
    from empose_tpu_torch.ops.precision import matmul_at

    cells, x, x_rev, lengths, args = bidi_inputs(f, n, seed, h)
    x_proj = torch.stack([matmul_at(xs, c["w_ih"], mode) + c["b_ih"] + c["b_hh"]
                          for c, xs in zip(cells, (x, x_rev))], dim=1).contiguous()
    return (cells, x, lengths), (x_proj,) + args[1:]


def bidi_mode_phase(f: int, n: int, mode: str, seed: int, h: int = HIDDEN,
                    timed: bool = True) -> dict:
    """The bidirectional layer kernel at ``mode`` (``mode_check``, the input
    projections at the mode too), with its launch plan; when ``timed``,
    median times beside the plain version at the mode and cuDNN's
    bidirectional LSTM in bf16, and the bound at the bf16 rate."""
    (cells, x, lengths), args = bidi_mode_inputs(f, n, mode, seed, h)
    x_proj, mask, _, h0, c0 = args
    shape = f"F={f} N={n}" + ("" if h == HIDDEN else f" H={h}")
    plan = K.lstm_bidi_plan(n, h, *K.bidi_limits(x_proj.device), precision=mode)
    print(f"mode {mode} bidi launch plan {shape}: {plan._asdict()}", flush=True)
    fresh = {0: torch.randn_like(x_proj) * 0.5, 3: torch.randn_like(h0) * 0.5}
    err = mode_check("bidi kernel", "lstm_bidi", shape, mode, K.lstm_bidi_fused,
                     K.lstm_bidi_plain, args, lengths == 0, h0, c0, fresh, plan.launches)
    if not timed:
        return dict(max_abs_err=err)
    lstm = torch.nn.LSTM(N_IN, h, 1, bidirectional=True).cuda()
    with torch.no_grad():
        for c, suffix in zip(cells, ("", "_reverse")):
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(c["w_ih"].t())
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(c["w_hh"].t())
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(c["b_ih"])
            getattr(lstm, f"bias_hh_l0{suffix}").copy_(c["b_hh"])
        lstm = lstm.bfloat16()
        xb, h0b, c0b = x.bfloat16(), h0.bfloat16(), c0.bfloat16()
        ms = cuda_ms(lambda: K.lstm_bidi_fused(*args, mode))
        plain_ms = cuda_ms(lambda: K.lstm_bidi_plain(*args, mode), warmup=1 if f > 256 else 3,
                           reps=3 if f > 256 else 7)
        library_ms = cuda_ms(lambda: lstm(xb, (h0b, c0b)))
    b_ms, b_by = bidi_mode_bound_ms(f, n, mode, h)
    print(f"mode {mode} bidi times {shape}: kernel {ms:.4f} ms ({ms * 1e3 / f:.2f} us per step), "
          f"plain at {mode} {plain_ms:.4f} ms, torch.nn.LSTM bidirectional in bf16 (cuDNN) "
          f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (bf16 tensor cores)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def pair_mode_bounds(f: int, n: int, mode: str, h: int = HIDDEN) -> dict:
    """Least times of the two sweeps at ``mode``: each sweep's product
    2*F*N*H*4H on the bf16 tensor cores (3 passes at high), and its bytes
    as ``pair_bounds`` counts them with W_hh in its bf16 form."""
    h4, parts = 4 * h, 2 if mode == "high" else 1
    flops = 2.0 * f * n * h * h4
    weights = 2.0 * parts * h * h4
    fwd_bytes = 4.0 * (f * n * h4 + f * n + 2 * n * h + f * n * h4 + 2 * f * n * h) + weights
    bwd_bytes = 4.0 * (3 * f * n * h + f * n * h4 + f * n + f * n * h4 + 2 * n * h) + weights
    return {"fwd": mode_bound_ms(flops, fwd_bytes, mode), "bwd": mode_bound_ms(flops, bwd_bytes, mode)}


def pair_mode_errors(f: int, n: int, mode: str, seed: int, h: int = HIDDEN) -> dict:
    """Both sweeps at ``mode`` on phase 4's inputs against their plain
    versions at the mode (and, at high, at highest): the largest max abs
    error over max abs value of each sweep's outputs, and the operands."""
    g = torch.Generator().manual_seed(seed)
    x_proj, mask, w_hh, h0, c0, lengths, dh_all, dc_all = pair_inputs(g, f, n, h)
    fwd_args = (x_proj, mask, w_hh, h0, c0, True)
    got = TK.lstm_train_fwd(*fwd_args, mode)
    want = TK.lstm_train_fwd_plain(*fwd_args, mode)
    c_prev = torch.cat([c0[None], want[2][:-1]])
    bwd_args = (dh_all, dc_all, want[0], c_prev, mask, w_hh)
    got_b = TK.lstm_train_bwd(*bwd_args, mode)
    want_b = TK.lstm_train_bwd_plain(*bwd_args, mode)
    worst = lambda a, b: max(rel_err(x, y) for x, y in zip(a, b))
    out = dict(fwd=worst(got, want), bwd=worst(got_b, want_b), fwd_abs=max_err(got, want),
               bwd_abs=max_err(got_b, want_b), got=got, want=want, got_b=got_b, want_b=want_b,
               fwd_args=fwd_args, bwd_args=bwd_args, lengths=lengths)
    if mode == "high":
        hi, hi_b = (TK.lstm_train_fwd_plain(*fwd_args, "highest"),
                    TK.lstm_train_bwd_plain(*bwd_args, "highest"))
        out.update(fwd_gap=worst(got, hi), bwd_gap=worst(got_b, hi_b),
                   fwd_abs_gap=max_err(got, hi), bwd_abs_gap=max_err(got_b, hi_b))
    return out


def pair_mode_phase(f: int, n: int, mode: str, seed: int, timed: bool, h: int = HIDDEN) -> dict:
    """Both training sweeps at ``mode`` against their plain versions at the
    mode (``pair_mode_errors``; TOL_PAIR_MODE, at high also closer to them
    than to the plain versions at highest), with their launch plans: one
    launch per call counted under the mode, 0-length rows frozen (state)
    and zero (dgates) bit for bit, a second launch and a CUDA-graph replay
    of each sweep bit for bit; when ``timed``, median times beside the
    plain versions at the mode and cuDNN's LSTM in bf16 (training forward;
    backward incl. dW and dx: a yardstick), and the bound at the bf16
    tensor-core rate."""
    shape = f"F={f} N={n}" + ("" if h == HIDDEN else f" H={h}")
    for name, plan in (("forward", TK.lstm_train_fwd_plan), ("reverse", TK.lstm_train_bwd_plan)):
        print(f"mode {mode} {name} sweep launch plan {shape}: "
              f"{plan(n, h, precision=mode)._asdict()}", flush=True)
    before = dict(K.MODE_LAUNCHES)
    e = pair_mode_errors(f, n, mode, seed, h)
    fwd_args, bwd_args = e["fwd_args"], e["bwd_args"]
    again = TK.lstm_train_fwd(*fwd_args, mode)
    again_b = TK.lstm_train_bwd(*bwd_args, mode)
    launched = {k: K.MODE_LAUNCHES.get((k, mode), 0) - before.get((k, mode), 0)
                for k in ("lstm_train_fwd", "lstm_train_bwd")}
    torch.cuda.synchronize()
    got, got_b, want, want_b = e["got"], e["got_b"], e["want"], e["want_b"]
    idle = e["lengths"].cuda() == 0
    h0, c0 = fwd_args[3], fwd_args[4]
    frozen = bool((got[1][:, idle] == h0[idle]).all() and (got[2][:, idle] == c0[idle]).all()
                  and (got_b[0][:, idle] == 0).all())
    repeat = (all(torch.equal(a, b) for a, b in zip(got, again)),
              all(torch.equal(a, b) for a, b in zip(got_b, again_b)))
    abs_err = {"fwd": e["fwd_abs"], "bwd": e["bwd_abs"]}
    replay = (graph_replays(lambda *a: TK.lstm_train_fwd(*a, mode), list(fwd_args),
                            {0: torch.randn_like(fwd_args[0]) * 0.5,
                             3: torch.randn_like(h0) * 0.5}),
              graph_replays(lambda *a: TK.lstm_train_bwd(*a, mode), list(bwd_args),
                            {0: torch.randn_like(bwd_args[0]), 2: bwd_args[2] * 0.5}))
    tol = TOL_PAIR_MODE[mode]
    gap = "" if mode != "high" else (f" (vs them at highest {e['fwd_gap']:.3e}, "
                                     f"{e['bwd_gap']:.3e})")
    print(f"mode {mode} training pair {shape}: max abs error / max abs value vs the plain "
          f"sweeps at {mode}: forward {e['fwd']:.3e}, reverse {e['bwd']:.3e}{gap} (tolerance "
          f"{tol:g}); max abs error {abs_err['fwd']:.3e}, {abs_err['bwd']:.3e}"
          + ("" if mode != "high" else f" (vs them at highest {e['fwd_abs_gap']:.3e}, "
                                       f"{e['bwd_abs_gap']:.3e})")
          + f"; 0-length rows "
          f"({int(idle.sum())}) frozen / zero bit for bit: {frozen}; second launch bit for bit: "
          f"{repeat}; CUDA-graph replay bit for bit: {replay}; launches {launched} for 2 calls "
          f"each (before the replays)", flush=True)
    for sweep in ("fwd", "bwd"):
        check(e[sweep] <= tol, f"training {sweep} sweep at {mode} disagrees with its plain version "
                               f"at {shape}: {e[sweep]} > {tol}")
        check(mode != "high" or e[f"{sweep}_abs"] < e[f"{sweep}_abs_gap"],
              f"training {sweep} sweep at high lies no closer to its plain version at high than "
              f"at highest at {shape}")
    check(launched == {"lstm_train_fwd": 2, "lstm_train_bwd": 2},
          f"training pair at {mode} {shape}: launches {launched} for 2 calls of each sweep")
    check(frozen, f"training pair at {mode} changed 0-length rows at {shape}")
    check(all(repeat), f"two training sweeps at {mode} on the same inputs differ at {shape}")
    check(all(replay), f"training pair at {mode}: a CUDA-graph replay differs at {shape}")
    rows = {k: dict(max_abs_err=abs_err[k]) for k in ("fwd", "bwd")}
    if not timed:
        return rows
    lstm = torch.nn.LSTM(h, h, 1).cuda()
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(fwd_args[2].t())
    lstm = lstm.bfloat16()
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(f, n, h, generator=g).cuda().bfloat16().requires_grad_()
    state = (h0[None].bfloat16(), c0[None].bfloat16())
    out_lib, _ = lstm(x, state)
    grad_lib = torch.ones_like(out_lib)
    lib_params = [x, *lstm.parameters()]
    reps = 7 if f > 64 else 15
    times = {
        "fwd": cuda_ms(lambda: TK.lstm_train_fwd(*fwd_args, mode)),
        "bwd": cuda_ms(lambda: TK.lstm_train_bwd(*bwd_args, mode)),
        "fwd_plain": cuda_ms(lambda: TK.lstm_train_fwd_plain(*fwd_args, mode), reps=reps),
        "bwd_plain": cuda_ms(lambda: TK.lstm_train_bwd_plain(*bwd_args, mode), reps=reps),
        "fwd_lib": cuda_ms(lambda: lstm(x, state)),
        "bwd_lib": cuda_ms(lambda: torch.autograd.grad(out_lib, lib_params, grad_lib,
                                                       retain_graph=True)),
    }
    bounds = pair_mode_bounds(f, n, mode, h)
    for k, name in (("fwd", "forward"), ("bwd", "reverse")):
        rows[k].update(ms=times[k], plain_ms=times[f"{k}_plain"], bound_ms=bounds[k][0],
                       bound_by=bounds[k][1], library_ms=times[f"{k}_lib"],
                       us_per_step=times[k] * 1e3 / f)
        print(f"mode {mode} training pair times {shape}: {name} kernel {times[k]:.4f} ms "
              f"({times[k] * 1e3 / f:.2f} us per step), plain at {mode} "
              f"{times[f'{k}_plain']:.4f} ms, cuDNN in bf16 {times[f'{k}_lib']:.4f} ms, bound "
              f"{bounds[k][0]:.4f} ms by {bounds[k][1]} (bf16 tensor cores)", flush=True)
    return rows


def pair_seed(f: int, n: int, h: int, seed: int = 0) -> int:
    """The seed of the pair's mode phase at (F, N, H) (seed 0), and of the
    other seeds of ``--mode-rounding``."""
    return 1000 * seed + SEED + f + n + (h != HIDDEN) * 1024


PAIR_MODE_SHAPES = (*((f, n, HIDDEN) for f, n in (*PAIR_TIMED, (33, 7), (1, 1), (3, 1300))),
                    (TRAIN_WINDOW, 32, 2 * HIDDEN))


def pair_modes() -> dict:
    """The training pair at each mode (``pair_mode_phase``) at every shape
    of phase 4, timed at PAIR_TIMED. Returns the flagship (64, 16) rows per
    mode."""
    rows = {}
    for mode in MODES:
        for f, n, h in PAIR_MODE_SHAPES:
            row = pair_mode_phase(f, n, mode, seed=pair_seed(f, n, h),
                                  timed=(f, n) in PAIR_TIMED and h == HIDDEN, h=h)
            if (f, n, h) == (TRAIN_WINDOW, TRAIN_BATCH, HIDDEN):
                rows[mode] = row
    return rows


def bf16_product_check() -> None:
    """The bf16 products outside the kernels (``ops/precision.mm_bf16``:
    cuBLAS's bf16 GEMM with an f32 output) at a layer-0 projection's shape,
    against an fp32 GEMM of the same bf16 values (exact products; the sums'
    order differs): an f32 result within 2e-6 of the largest value (about
    8x the reading on an H100, 2.575e-07; a bf16 result is 4e-3 off)."""
    from empose_tpu_torch.ops.precision import mm_bf16

    g = torch.Generator().manual_seed(SEED)
    a = torch.randn(STREAMS * CHUNK, N_IN, generator=g).cuda().bfloat16()
    b = torch.randn(N_IN, 4 * HIDDEN, generator=g).cuda().bfloat16()
    got, want = mm_bf16(a, b), a.float() @ b.float()
    rel = max_err((got,), (want,)) / float(want.abs().max())
    print(f"mode: bf16 product outside the kernels (torch.mm, out_dtype float32) returns "
          f"{got.dtype}; relative max error vs fp32 GEMM of the bf16 values {rel:.3e} "
          f"(tolerance 2e-6)", flush=True)
    check(got.dtype == torch.float32 and rel <= 2e-6,
          f"the bf16 product returns {got.dtype}, {rel} from the fp32 GEMM of its operands")


def kernel_modes() -> dict:
    """Every mode phase of the kernels: the stack and the wavefront at
    STACK_TIMED (timed), (33, 7) and (3, 1300) at 2x512, the stack at one
    layer of 1024 (16, 64) (timed), both at 3x448 and 4x352 (16, 48) (three
    and four states a chunk in the wavefront's ring: two teams on eight
    slots at default, one team on two slots at high; the stack order at
    3x448 high: one team on two slots, two items a chunk, three chunks);
    the bidi layer at BIDI_TIMED, H=1024 (16, 32) and the eval's (4096, 17)
    (timed). Returns the (16, 64) rows per mode."""
    rows = {}
    for mode in MODES:
        stack = {}
        for f, n in (*STACK_TIMED, (33, 7), (3, 1300)):
            stack[(f, n)] = stack_mode_phase(f, n, mode, seed=SEED + f + n,
                                             timed=(f, n) in STACK_TIMED)
        stack_mode_phase(CHUNK, STREAMS, mode, seed=SEED + 1024, h=2 * HIDDEN, layers=1)
        for h, layers in ((448, 3), (352, 4)):
            stack_mode_phase(CHUNK, 48, mode, seed=SEED + h, h=h, layers=layers, timed=False)
        bidi = {}
        for f, n, h in BIDI_MODE_SHAPES:
            bidi[(f, n, h)] = bidi_mode_phase(f, n, mode, seed=SEED + f + n + 1, h=h)
        rows[mode] = dict(stack=stack[(CHUNK, STREAMS)], bidi=bidi[(CHUNK, STREAMS, HIDDEN)])
    return rows


def sass_functions(name: str) -> dict:
    """The SASS of each LSTM kernel instantiation of a built library
    (``cuobjdump -sass``) by (kernel, U, wavefront, mode), each a list of
    instructions without addresses and with the kernel parameters'
    constant-bank offsets masked (a tree whose kernels lack the mode
    argument: highest)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", cuda_build.library_path(name)], capture_output=True,
                          text=True, check=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(lstm_[a-z_]+?_kernel)ILi(\d)E(?:Lb(\d)E)?(?:Li(\d)E)?E", line)
            fn = None if m is None else (m.group(1), int(m.group(2)), m.group(3) == "1",
                                         ("highest", "high", "default")[int(m.group(4) or 0)])
            if fn is not None:
                funcs[fn] = []
        elif fn is not None:
            ins = re.sub(r"/\*[^*]*\*/", "", line).strip().rstrip(";").strip()
            if ins:
                funcs[fn].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]", ins))
    return funcs


def hmma_counts(name: str) -> dict:
    """HMMA instructions per kernel instantiation of a built library, by
    (kernel, U, wavefront, mode)."""
    return {k: sum("HMMA" in ins for ins in v) for k, v in sass_functions(name).items()}


def served_joints(sensor: SensorSMPL, out: dict) -> torch.Tensor:
    """FK joints (B, 22, 3) of a served chunk (root_ori, pose_body[, shape])."""
    poses = torch.from_numpy(np.concatenate([out["root_ori"], out["pose_body"]], -1)).cuda()
    shapes = torch.from_numpy(out["shape"]).cuda() if "shape" in out else \
        poses.new_zeros(poses.shape[0], 10)
    return sensor.joints(poses, shapes[:, :10]).reshape(poses.shape[0], -1, 3)


def joint_shift_mm(sensor: SensorSMPL, a: list, b: list) -> float:
    """The largest FK joint difference (mm) between two runs of served steps."""
    worst = 0.0
    with torch.no_grad():
        for x, y in zip(a, b):
            for s in x:
                d = (served_joints(sensor, x[s]) - served_joints(sensor, y[s])).norm(dim=-1)
                worst = max(worst, float(d.max()) * 1e3)
    return worst


def serving_mode_path(label: str, model_id: str, feeds, offsets, kernel: str, per_forward: int,
                      use_plain, mode: str, base: list, sensor: SensorSMPL) -> int:
    """Serve ``model_id`` at ``mode`` (both knobs bound by the caller, as the
    serve CLI's --precision binds them) through
    MultiStreamPredictor.from_experiment and one StreamingPredictor session
    with the counts at 0: ``kernel`` must launch ``per_forward`` times per served forward,
    all at ``mode``, and no other kernel; the served poses must equal the
    same model with its LSTM's plain version at ``mode`` within
    TOL_SERVE_MODE; the shift from the ``highest`` run ``base`` (largest
    FK joint difference, mm), the batched step's p50 and one profiled
    window. Returns the kernel's launches."""
    multi = MultiStreamPredictor.from_experiment(model_id, n_streams=STREAMS, chunk_size=CHUNK)
    model = multi.model
    single = StreamingPredictor(model, CHUNK)
    torch.cuda.synchronize()
    reset_counts()
    served = serve_rounds(multi, feeds, offsets)
    single_out = single_session(single, feeds, offsets)
    torch.cuda.synchronize()
    launched, by_mode = counts(), dict(K.MODE_LAUNCHES)
    forwards = len(served) + 4
    print(f"{label} at {mode} main path: {forwards} served forwards, launches {launched}, by "
          f"mode {by_mode}", flush=True)
    check(launched == expected(**{kernel: per_forward * forwards})
          and by_mode == {(kernel, mode): per_forward * forwards},
          f"{label} at {mode}: expected {per_forward} {kernel} launches at {mode} per served "
          f"forward and no other kernel, got {launched}, {by_mode}")
    ref_model = copy.deepcopy(model)
    use_plain(ref_model)
    ref_served = serve_rounds(MultiStreamPredictor(ref_model, STREAMS, CHUNK), feeds, offsets)
    ref_single = single_session(StreamingPredictor(ref_model, CHUNK), feeds, offsets)
    check(counts() == launched, f"{label} at {mode}: the plain reference launched a kernel")
    finite = all(np.isfinite(v).all() for o in served for s in o.values() for v in s.values())
    err = max(max(max_diff(a, b) for a, b in zip(served, ref_served)),
              max(max_diff(a, b) for a, b in zip(single_out, ref_single)))
    shift = joint_shift_mm(sensor, served, base)
    pos, ori = feeds

    def batched_step() -> float:
        for s in range(STREAMS):
            multi.push(s, pos[s, :CHUNK], ori[s, :CHUNK])
        t0 = time.perf_counter()
        multi.step()
        return (time.perf_counter() - t0) * 1e3

    step_ms = [batched_step() for _ in range(20)]
    p50 = float(np.median(step_ms))
    print(f"{label} at {mode}: outputs finite {finite}; max |kernel path - plain LSTM path at "
          f"{mode}| {err:.3e} (tolerance {TOL_SERVE_MODE[mode]:g}); shift from highest: largest "
          f"joint difference {shift:.4f} mm; {STREAMS} streams x chunk {CHUNK}: p50 "
          f"{p50:.3f} ms per batched step (min {min(step_ms):.3f}, max {max(step_ms):.3f})",
          flush=True)
    check(finite, f"{label} at {mode}: served outputs are not finite")
    check(err <= TOL_SERVE_MODE[mode], f"{label} at {mode}: served outputs differ from the "
                                       f"plain-LSTM forward: {err} > {TOL_SERVE_MODE[mode]}")
    profile_window(f"{label} at {mode} serving", batched_step, 5)
    return launched[kernel]


def eval_mode_path(label: str, model_id: str, kernel: str, window, base: dict,
                   mode: str = "default") -> int:
    """The eval CLI's main at ``--precision mode`` with the counts at 0:
    ``kernel`` launches as at ``highest``, all at the mode, and no other
    kernel; the table's MPJPE, PA-MPJPE and MPJAE shift from the ``highest``
    table ``base`` (overall row; within TOL_EVAL_MODE relative), then one
    batched pass at the mode timed on the host clock and one profiled (its
    device busy time and the kernel's). Returns the launches."""
    from empose_tpu_torch.device import precision_scope

    argv = ["--model_id", model_id]
    torch.cuda.synchronize()
    reset_counts()
    rows, _ = quiet_eval(argv + ["--precision", mode])
    torch.cuda.synchronize()
    launched, by_mode = counts(), dict(K.MODE_LAUNCHES)
    want = base["launches"]
    check(launched == expected(**{kernel: want}) and by_mode == {(kernel, mode): want},
          f"{label} eval at {mode}: expected {want} {kernel} launches at {mode}, got "
          f"{launched}, {by_mode}")
    got, ref = np.array(rows[-1][1:], float), np.array(base["rows"][-1][1:], float)
    shift = dict(zip(("MPJPE", "PA-MPJPE", "MPJAE"), (got - ref)[[0, 2, 4]]))
    rel = table_diff(rows, base["rows"])
    session, loader, _ = EH.load_model_and_eval_data(model_id)
    frames = sum(int(b["seq_lengths"][0]) for b in loader)
    with precision_scope(mode), contextlib.redirect_stdout(io.StringIO()):
        EH.evaluate_real_sequences(session, loader, window)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        EH.evaluate_real_sequences(session, loader, window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev = device_ms(lambda: EH.evaluate_real_sequences(session, loader, window), reps=1)
    kernel_ms = sum(v for k, v in dev.items() if f"{kernel}_kernel" in k)
    print(f"{label} eval at {mode}: launches {launched}; overall row {rows[-1][1:]}; shift from "
          f"highest (mm, mm, deg) {shift}; largest relative difference to the highest table "
          f"{rel:.3e} (tolerance {TOL_EVAL_MODE:g}); batched pass wall {wall:.3f} s, "
          f"{frames / wall:.0f} frames/s (highest: {base['wall_s']:.3f} s, "
          f"{base['frames_per_s']:.0f} frames/s); profiled pass: device busy "
          f"{sum(dev.values()):.1f} ms, the {kernel} kernel {kernel_ms:.1f} ms", flush=True)
    check(all(np.isfinite(r[1:]).all() for r in rows) and len(rows) == len(base["rows"]),
          f"{label} eval at {mode}: the table is not finite or has other rows")
    check(rel <= TOL_EVAL_MODE, f"{label} eval at {mode}: the table moved {rel} > "
                                f"{TOL_EVAL_MODE} from highest's")
    return launched[kernel]


def mode_cases():
    """Every (kind, F, N, H, L) that kernel_modes and pair_modes check."""
    return ([("stack", f, n, HIDDEN, LAYERS) for f, n in (*STACK_TIMED, (33, 7), (3, 1300))]
            + [("stack", CHUNK, STREAMS, 2 * HIDDEN, 1)]
            + [("bidi", f, n, h, 1) for f, n, h in BIDI_MODE_SHAPES]
            + [("pair", f, n, h, 1) for f, n, h in PAIR_MODE_SHAPES])


def mode_rounding_study(seeds=range(8)) -> int:
    """How far each kernel at HIGH and DEFAULT lies from its plain version
    at the same mode, over seeds and every shape kernel_modes checks (seed
    0 is its inputs): at DEFAULT a 1-ulp fp32 difference in h can round an
    element of the next step's bf16 h the other way. At HIGH also the gap
    to the plain version at HIGHEST, which TOL_HIGH must stay under. Prints
    each reading and, per shape and mode, the largest reading (and the
    smallest gap); they set TOL_MODE."""
    if not print_card():
        return 2
    set_precision("highest")
    for mode in MODES:
        worst, gap, pair_worst, pair_gap, pair_margin = {}, {}, {}, {}, {}
        for seed in seeds:
            for kind, f, n, h, layers in mode_cases():
                if kind == "pair":
                    e = pair_mode_errors(f, n, mode, pair_seed(f, n, h, seed), h)
                    line = f"mode-rounding {mode} seed {seed} training pair F={f} N={n} H={h}:"
                    for sweep in ("fwd", "bwd"):
                        key = f"train_{sweep} F={f} N={n} H={h}"
                        pair_worst[key] = max(pair_worst.get(key, 0.0), e[sweep])
                        line += f" {sweep} {e[sweep]:.3e}"
                        if mode == "high":
                            g = e[f"{sweep}_gap"]
                            pair_gap[key] = min(pair_gap.get(key, g), g)
                            margin = e[f"{sweep}_abs_gap"] / max(e[f"{sweep}_abs"], 1e-30)
                            pair_margin[key] = min(pair_margin.get(key, margin), margin)
                            line += (f" (gap to highest {g:.3e}; max abs error {e[sweep + '_abs']:.3e}"
                                     f", to highest {e[sweep + '_abs_gap']:.3e})")
                    print(line + " (max abs error / max abs value)", flush=True)
                    continue
                if kind == "stack":
                    cells, x, mask, h0, c0 = stack_case(f, n, 1000 * seed + f + n, h, layers)
                    ops = K.stack_operands(cells, x, mode)
                    args = (ops[0], mask, ops[1], ops[2], ops[3], h0, c0)
                    pairs = [("stack", K.lstm_stack_fused, K.lstm_stack_plain)]
                    if layers > 1:
                        pairs.append(("wavefront", K.lstm_stack_wavefront_fused,
                                      K.lstm_stack_wavefront_plain))
                else:
                    args = bidi_mode_inputs(f, n, mode, 1000 * seed + f + n + 1, h)[1]
                    pairs = [("bidi", K.lstm_bidi_fused, K.lstm_bidi_plain)]
                for name, fused, plain in pairs:
                    got = fused(*args, mode)
                    err = max_err(got, plain(*args, mode))
                    key = f"{name} F={f} N={n} H={h}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    line = f"mode-rounding {mode} seed {seed} {key}: {err:.3e}"
                    if mode == "high":
                        g = max_err(got, plain(*args, "highest"))
                        gap[key] = min(gap.get(key, g), g)
                        line += f"; gap to the plain version at highest {g:.3e}"
                    print(line, flush=True)
        print(f"mode-rounding {mode}: largest over {len(seeds)} seeds {worst}; overall "
              f"{max(worst.values()):.3e}", flush=True)
        if gap:
            print(f"mode-rounding {mode}: smallest gap to highest over {len(seeds)} seeds {gap}; "
                  f"overall {min(gap.values()):.3e}", flush=True)
        print(f"mode-rounding {mode}: training pair, largest max abs error / max abs value over "
              f"{len(seeds)} seeds {pair_worst}; overall {max(pair_worst.values()):.3e}",
              flush=True)
        if pair_gap:
            print(f"mode-rounding {mode}: training pair, smallest gap to highest {pair_gap}; "
                  f"overall {min(pair_gap.values()):.3e}; smallest ratio of the max abs errors "
                  f"to highest and to high {pair_margin}; overall "
                  f"{min(pair_margin.values()):.2f}", flush=True)
    return 0


def profilers_only() -> int:
    """The profilers phase alone, on a fresh build of the stack and training
    kernels and the smoke's asset tree: its checks and lines, no kernels line."""
    if not print_card():
        return 2
    set_precision("highest")
    cuda_build.build([K.NAME, TK.NAME], force=True)
    profiler_stack_checks()
    profiler_pair_checks()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        write_assets(root, np.random.RandomState(SEED))
        prof = profilers_path(LGD_RNN_6["m_rnn_num_layers"], stack_forward_launches(LAYERS, HIDDEN))
    print(f"the profilers: launches {prof}; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def main() -> int:
    if not print_card():
        return 2
    t_start = time.perf_counter()
    laps = Laps()
    set_precision("highest")

    t0 = time.perf_counter()
    logs = cuda_build.build([K.NAME, K.BIDI_NAME, TK.NAME, SK.NAME], force=True, verbose=True)
    for name, log in logs.items():
        regs = sorted({line.split("info    : ")[-1] for line in log.splitlines()
                       if "registers" in line or "spill" in line})
        print(f"build {name}: {'; '.join(regs)}", flush=True)
    spills = [line for line in logs[SK.NAME].splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(not spills, f"the LBS kernel spills registers: {spills}")
    pair = {fn: lines for fn, lines in ptxas_report(logs[TK.NAME]).items()
            if "lstm_train_fwd_kernel" in fn or "lstm_train_bwd_kernel" in fn}
    for fn, lines in sorted(pair.items()):
        print(f"build {TK.NAME} {fn}: {'; '.join(lines)}", flush=True)
    spills = [line for lines in pair.values() for line in lines
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    # U = 1, 2, 4, 8 at highest; U = 2, 4, 8 at high and default: 10 per sweep.
    check(len(pair) == 20 and not spills, f"the training pair's instantiations {sorted(pair)} "
                                          f"do not all build without spills: {spills}")
    bidi_fns = {fn: lines for fn, lines in ptxas_report(logs[K.BIDI_NAME]).items()
                if "lstm_bidi_kernel" in fn}
    for fn, lines in sorted(bidi_fns.items()):
        print(f"build {K.BIDI_NAME} {fn}: {'; '.join(lines)}", flush=True)
    spills = [line for lines in bidi_fns.values() for line in lines
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(len(bidi_fns) == 6 and not spills, f"the bidi kernel's instantiations "
                                             f"{sorted(bidi_fns)} do not all build without "
                                             f"spills: {spills}")
    stack_fns = {fn: lines for fn, lines in ptxas_report(logs[K.NAME]).items()
                 if "lstm_stack_kernel" in fn}
    for fn, lines in sorted(stack_fns.items()):
        print(f"build {K.NAME} {fn}: {'; '.join(lines)}", flush=True)
    spills = [line for lines in stack_fns.values() for line in lines
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(len(stack_fns) == 9 and not spills, f"the stack kernel's instantiations "
                                              f"{sorted(stack_fns)} do not all build without "
                                              f"spills: {spills}")
    print(f"build: nvcc {time.perf_counter() - t0:.2f} s for {len(logs)} sources in parallel",
          flush=True)
    # The tensor cores: HMMA in every HIGH and DEFAULT instantiation of the
    # stack, bidi and training kernels, in none of the HIGHEST ones.
    for name, n_fns in ((K.NAME, 9), (K.BIDI_NAME, 6), (TK.NAME, 20)):
        hmma = hmma_counts(name)
        print(f"build {name}: HMMA instructions per instantiation (kernel, U, wavefront, mode) "
              f"{ {k: v for k, v in sorted(hmma.items())} }", flush=True)
        check(len(hmma) == n_fns
              and all((v > 0) == (k[-1] != "highest") for k, v in hmma.items()),
              f"{name}: HMMA not in exactly the high and default instantiations: {hmma}")
    laps.lap("build")

    # Timed: STACK_TIMED at 2x512 (one stream's chunk also in rounds against
    # cuDNN) and one layer of the default width 1024 at the serving chunk,
    # beside the whole 2x1024 stack as lstm_stack runs it; checked: a ragged
    # batch, more rows than one staging holds, and the widths that take the
    # plan's other modes (L=3 at H=64, fewer float4 columns than lanes; a
    # ring of 5 slots at H=260; U=8 with all rows staged at H=1000).
    stack = {(f, n): stack_phase(f, n, seed=SEED + f + n, rounds=11 if n == 1 else 0)
             for f, n in STACK_TIMED}
    for f, n in ((33, 7), (3, 1300)):
        stack_phase(f, n, seed=SEED + f + n, timed=False)
    stack_phase(CHUNK, STREAMS, seed=SEED + 1024, h=2 * HIDDEN, layers=1)
    stack_default_width_times(CHUNK, STREAMS, seed=SEED + 1024)
    for f, n, h, layers in ((CHUNK, 7, 64, 3), (CHUNK, 300, 260, 2), (CHUNK, 20, 1000, 1)):
        stack_phase(f, n, seed=SEED + h, h=h, layers=layers, timed=False)
    # The gate's LGD-RNN-6 eval window and validation batch (one 256-frame
    # window of one recording; batches of 6 windows of 32).
    for f, n in ((256, 1), (32, 6)):
        stack_phase(f, n, seed=SEED + f + n, timed=False)
    profiler_stack_checks()
    laps.lap("stack kernel against its plain version")
    # Timed: PAIR_TIMED; checked: a ragged batch, one step of one row, more
    # rows than either sweep could keep in shared memory.
    pair = {(f, n): train_pair_phase(f, n, seed=SEED + f + n, timed=(f, n) in PAIR_TIMED)
            for f, n in (*PAIR_TIMED, (33, 7), (1, 1), (3, 1300))}
    # H=1024, where the forward sweep's ring has one slot.
    train_pair_phase(TRAIN_WINDOW, 32, seed=SEED + 1024, timed=False, h=2 * HIDDEN)
    # The gates' steps: LGD-RNN-6 at batch 12 x window 32 (4 at an epoch's
    # end), demo_convergence's BiRNN at H=128, batch 16 (8 at an epoch's end).
    for f, n, h in ((32, 12, HIDDEN), (32, 4, HIDDEN), (32, 16, DEMO_HIDDEN),
                    (32, 8, DEMO_HIDDEN)):
        train_pair_phase(f, n, seed=SEED + f + n + h, timed=False, h=h)
    profiler_pair_checks()
    laps.lap("training pair against its plain versions")
    # Timed: BIDI_TIMED and, at H=1024 (one direction per launch), (16, 32);
    # checked: a ragged batch, more rows than one staging holds, and the
    # widths that take the plan's other instance and modes.
    bidi = {(f, n): bidi_phase(f, n, seed=SEED + f + n + 1) for f, n in BIDI_TIMED}
    for f, n in ((33, 7), (3, 1300)):
        bidi_phase(f, n, seed=SEED + f + n + 1, timed=False)
    bidi_phase(CHUNK, 32, seed=SEED + 1024, h=2 * HIDDEN)
    for n, h in ((7, 64), (STREAMS, 260), (7, 516)):
        bidi_phase(CHUNK, n, seed=SEED + h, h=h, timed=False)
    # The longest whole-sequence forward of the eval phase (F=4096), at one
    # row more than the eval corpus holds.
    bidi_phase(*BIDI_LONG, seed=SEED + BIDI_LONG[0])
    # demo_convergence's whole-sequence eval forward at H=128 (200 frames padded to 256).
    bidi_phase(256, 1, seed=SEED + DEMO_HIDDEN, h=DEMO_HIDDEN, timed=False)
    laps.lap("bidi kernel against its plain version")
    # Timed: an export chunk, a batch, one frame; checked: the SMPLLayer.fk
    # call, the export's last chunk, a ragged chunk.
    lbs = {n: lbs_phase(n, seed=SEED + n + 3, timed=n in (512, 64, 1))
           for n in (512, 64, 1, SMPL_FRAMES, 76, 7)}
    lbs_refuses_strided()
    wavefront_launches = bench_path()
    laps.lap("LBS kernel and the bench tool")

    # The high and default modes of the stack, wavefront and bidi kernels,
    # and the bench tool at each mode.
    bf16_product_check()
    modes = kernel_modes()
    laps.lap("stack, wavefront and bidi kernels at high and default")
    pair_rows = pair_modes()
    laps.lap("training pair at high and default")
    mode_launches = {(k, m): 0 for k in ("lstm_stack", "lstm_wavefront", "lstm_bidi",
                                         "lstm_train_fwd", "lstm_train_bwd") for m in MODES}
    for mode in MODES:
        mode_launches[("lstm_wavefront", mode)] = bench_path(mode)
    laps.lap("the bench tool at high and default")

    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        rng = np.random.RandomState(SEED)
        write_assets(root, rng)
        n_params = write_experiment(root, "900001", LGD_RNN_6, "LGD-RNN-6")
        print(f"model: LGD-RNN-6, {n_params} parameters (seeded random weights)", flush=True)
        n_params = write_experiment(root, "900003", BIRNN_6, "BiRNN-6")
        print(f"model: BiRNN-6, {n_params} parameters (seeded random weights)", flush=True)
        check(n_params == 9_295_697, "BiRNN-6 does not have the released parameter count")
        laps.lap("the smoke's asset tree")
        feeds = sensor_feeds(SensorSMPL(load_smplh()).cuda(), STREAMS, CHUNK * CHUNKS, rng)
        offsets = [(o["means"], o["r"]) for o in (make_offset_data(rng) for _ in range(STREAMS))]

        def plain_stack(model):
            model.rnn.lstm_stack = K.lstm_stack_plain

        def plain_bidi(model):
            model.rnn.lstm_bidi = K.lstm_bidi_plain

        # The stack runs whole where it fits the card, else one layer per launch.
        stack_per_forward = stack_forward_launches(LAYERS, HIDDEN)
        launches, lgd_served = serving_path("LGD-RNN-6", "900001", feeds, offsets, "lstm_stack",
                                            stack_per_forward, plain_stack)
        bidi_launches, birnn_served = serving_path("BiRNN-6", "900003", feeds, offsets,
                                                   "lstm_bidi", BIRNN_6["m_num_layers"],
                                                   plain_bidi)

        # The default-width RNNs (H=1024): the stack one layer per launch,
        # the bidirectional layer one direction per launch.
        h_default, layers = RNN_DEFAULT["m_hidden_size"], RNN_DEFAULT["m_num_layers"]
        per_forward = stack_forward_launches(layers, h_default)
        n_params = write_experiment(root, "900005", RNN_DEFAULT, "RNN-1024")
        print(f"model: RNN at the default width ({layers}x{h_default}), {n_params} parameters "
              f"(seeded random weights); {per_forward} stack launches per forward", flush=True)
        rnn_served = serving_path("RNN-1024", "900005", feeds, offsets, "lstm_stack",
                                  per_forward, plain_stack)[1]
        per_forward = layers * bidi_layer_launches(STREAMS, h_default)
        n_params = write_experiment(root, "900006", BIRNN_DEFAULT, "BiRNN-1024")
        print(f"model: BiRNN at the default width ({layers}x{h_default}), {n_params} parameters "
              f"(seeded random weights); {per_forward} bidi launches per forward", flush=True)
        birnn_default_served = serving_path("BiRNN-1024", "900006", feeds, offsets, "lstm_bidi",
                                            per_forward, plain_bidi)[1]
        laps.lap("serving")

        # Serving at each mode: the four models, their kernels at the mode
        # (launches per forward by the plan at the mode), held against the
        # plain LSTM at the mode, and shifted from the highest runs above.
        from empose_tpu_torch.device import precision_scope

        sensor = SensorSMPL(load_smplh()).cuda()
        for mode in MODES:
            for label, model_id, kernel, per, use_plain, base in (
                    ("LGD-RNN-6", "900001", "lstm_stack",
                     stack_forward_launches(LAYERS, HIDDEN, mode), plain_stack, lgd_served),
                    ("BiRNN-6", "900003", "lstm_bidi",
                     BIRNN_6["m_num_layers"] * bidi_layer_launches(STREAMS, HIDDEN, mode),
                     plain_bidi, birnn_served),
                    ("RNN-1024", "900005", "lstm_stack",
                     stack_forward_launches(layers, h_default, mode), plain_stack, rnn_served),
                    ("BiRNN-1024", "900006", "lstm_bidi",
                     layers * bidi_layer_launches(STREAMS, h_default, mode), plain_bidi,
                     birnn_default_served)):
                with precision_scope(mode):
                    mode_launches[(kernel, mode)] += serving_mode_path(
                        label, model_id, feeds, offsets, kernel, per, use_plain, mode, base,
                        sensor)
        laps.lap("serving at high and default")

        n_layers = LGD_RNN_6["m_rnn_num_layers"]
        trained = training_path("LGD-RNN-6", LGD_RNN_6, "900002", TRAIN_STEPS, RESUME_STEPS,
                                n_layers, "lstm_stack", stack_per_forward)
        training_step_vs_plain("LGD-RNN-6", trained["trainer"], n_layers, TOL_GRAD_LGD)
        training_times("LGD-RNN-6", trained["trainer"])
        trained_fwd, trained_bwd = trained["fwd"], trained["bwd"]
        launches += trained["lstm_stack"]
        lgd_losses = train_losses(trained["model_dir"])
        del trained
        laps.lap("LGD-RNN-6 training")

        # Sensor-fault noise: on the card alone, then LGD-RNN-6 trained with
        # each noise type, resumed, and held against an uninterrupted run.
        noise_phase()
        for kind, flags, ids in (
                ("suppression", ["--suppression_noise_length", "0.5", "--noise_num_markers", "2"],
                 ("900030", "900031")),
                ("spherical", ["--spherical_noise_strength", "0.5",
                               "--spherical_noise_length", "0.5"], ("900032", "900033"))):
            noisy = training_path(f"LGD-RNN-6 with {kind} noise", LGD_RNN_6, ids[0], NOISY_STEPS,
                                  NOISY_RESUME_STEPS, n_layers, "lstm_stack", stack_per_forward,
                                  flags, uninterrupted_id=ids[1])
            noisy_losses = train_losses(noisy["model_dir"])
            check(noisy_losses[1] != lgd_losses[1], f"{kind} noise did not change the first "
                                                    "step's loss")
            trained_fwd, trained_bwd = trained_fwd + noisy["fwd"], trained_bwd + noisy["bwd"]
            launches += noisy["lstm_stack"]
            del noisy
        laps.lap("noise and noisy training")
        # --remat (same step, bit for bit; memory and p50) and --profile_dir.
        fwd, bwd = remat_path(n_layers)
        trained_fwd, trained_bwd = trained_fwd + fwd, trained_bwd + bwd
        fwd, bwd, stack_launches = profile_path(n_layers, stack_per_forward, root)
        trained_fwd, trained_bwd = trained_fwd + fwd, trained_bwd + bwd
        launches += stack_launches
        laps.lap("--remat and --profile_dir")

        per_step = 2 * BIRNN_6["m_num_layers"]
        bidi_per_forward = BIRNN_6["m_num_layers"] * bidi_layer_launches(1, HIDDEN)
        birnn = training_path("BiRNN-6", BIRNN_6, "900004", BIRNN_TRAIN_STEPS,
                              BIRNN_RESUME_STEPS, per_step, "lstm_bidi", bidi_per_forward)
        training_step_vs_plain("BiRNN-6", birnn["trainer"], per_step, TOL_GRAD_REL)
        training_times("BiRNN-6", birnn["trainer"])
        bidi_launches += birnn["lstm_bidi"]
        birnn_losses = train_losses(birnn["model_dir"])
        del birnn
        laps.lap("BiRNN-6 training")

        # Training at the modes: `--matmul_precision high` and `--bf16`
        # (default), from the seed of the highest runs above.
        for mode, flags, ids in (("high", ["--matmul_precision", "high"], ("900012", "900014")),
                                 ("default", ["--bf16"], ("900013", "900015"))):
            for label, cfg, model, experiment_id, per, kernel, per_forward, base in (
                    ("LGD-RNN-6", LGD_RNN_6, "lgd", ids[0], n_layers, "lstm_stack",
                     stack_forward_launches(LAYERS, HIDDEN, mode), lgd_losses),
                    ("BiRNN-6", BIRNN_6, "birnn", ids[1], per_step, "lstm_bidi",
                     BIRNN_6["m_num_layers"] * bidi_layer_launches(1, HIDDEN, mode),
                     birnn_losses)):
                run = training_mode_path(label, cfg, model, experiment_id, mode, flags, per,
                                         kernel, per_forward, base)
                for k, v in run.items():
                    mode_launches[(k, mode)] += v
        laps.lap("training at high and default")

        # Real-data evaluation: LGD-RNN-6 in windows of 256 frames (the
        # stack kernel), BiRNN-6 over whole sequences (the bidirectional
        # layer kernel, one launch per layer at H=512 for any N).
        lgd_eval = eval_path("LGD-RNN-6", "900001", "lstm_stack", lambda n: stack_per_forward,
                             256)
        birnn_eval = eval_path("BiRNN-6", "900003", "lstm_bidi",
                               lambda n: BIRNN_6["m_num_layers"] * bidi_layer_launches(n, HIDDEN),
                               None)
        launches += lgd_eval["launches"]
        laps.lap("evaluation")
        # Evaluation under suppression, and the suppression study.
        launches += suppression_eval_path("LGD-RNN-6", "900001", lgd_eval["rows"],
                                          stack_per_forward, 256)
        launches += study_path("LGD-RNN-6", "900001", stack_per_forward, 256, root)[0]
        laps.lap("evaluation under suppression and the study")
        bidi_launches += birnn_eval["launches"] + eval_fit_path(
            "BiRNN-6", BIRNN_6, "900007", per_step, "lstm_bidi", bidi_per_forward)
        # The eval CLI at --precision default: the same launches, at the mode.
        mode_launches[("lstm_stack", "default")] += eval_mode_path(
            "LGD-RNN-6", "900001", "lstm_stack", 256, lgd_eval)
        mode_launches[("lstm_bidi", "default")] += eval_mode_path(
            "BiRNN-6", "900003", "lstm_bidi", None, birnn_eval)
        laps.lap("fit through an eval boundary, evaluation at default")

        # Data parallelism, --steps_per_call, sharded serving, bulk datagen
        # and the serving bench.
        fwd, bwd = dp_training_path(root, n_layers)
        trained_fwd, trained_bwd = trained_fwd + fwd, trained_bwd + bwd
        laps.lap("data parallelism")
        fwd, bwd, stack_launches = steps_per_call_path(n_layers, stack_per_forward)
        trained_fwd, trained_bwd = trained_fwd + fwd, trained_bwd + bwd
        launches += stack_launches
        launches += sharded_serving_path(feeds, offsets, lgd_served, stack_per_forward)
        bulk_datagen_path(root)
        launches += bench_serve_path(stack_per_forward)
        laps.lap("--steps_per_call, sharded serving, bulk datagen, bench_serve")

        # The profilers and measure_remat at their full regimes.
        prof = profilers_path(n_layers, stack_per_forward)
        launches += prof["highest"]["lstm_stack"]
        trained_fwd += prof["highest"]["lstm_train_fwd"]
        trained_bwd += prof["highest"]["lstm_train_bwd"]
        for k, v in prof["default"].items():
            mode_launches[(k, "default")] += v
        laps.lap("the profilers")

        # The asset writer and the training gates, LGD-RNN-6 and a BiRNN
        # trained to convergence, on a tree of their own.
        gates = gates_path(n_layers, stack_per_forward, laps)
        launches += gates["lstm_stack"]
        bidi_launches += gates["lstm_bidi"]
        trained_fwd += gates["lstm_train_fwd"]
        trained_bwd += gates["lstm_train_bwd"]

        layer, lbs_launches = smpl_layer_path(rng)
        datagen_path(root, rng)
        lbs_launches += export_path(root, layer, rng)
        laps.lap("SMPLLayer, datagen, export")

    f16 = stack[(CHUNK, STREAMS)]["stack"]
    flagship = pair[(TRAIN_WINDOW, TRAIN_BATCH)]
    kernels = [
        dict(name="lstm_stack", route="cuda", source="empose_tpu_torch/csrc/lstm_stack.cu",
             replaces="empose_tpu/ops/lstm_kernel.py:150", launches=launches, **f16),
        dict(name="lstm_bidi", route="cuda", source="empose_tpu_torch/csrc/lstm_bidi.cu",
             replaces="empose_tpu/ops/lstm_kernel.py:589", launches=bidi_launches,
             **bidi[(CHUNK, STREAMS)]),
        dict(name="lstm_train_fwd", route="cuda", source="empose_tpu_torch/csrc/lstm_train.cu",
             replaces="empose_tpu/ops/lstm_train_kernel.py:136", launches=trained_fwd,
             **flagship["fwd"]),
        dict(name="lstm_train_bwd", route="cuda", source="empose_tpu_torch/csrc/lstm_train.cu",
             replaces="empose_tpu/ops/lstm_train_kernel.py:244", launches=trained_bwd,
             **flagship["bwd"]),
        dict(name="lbs", route="cuda", source="empose_tpu_torch/csrc/lbs.cu",
             replaces="empose_tpu/ops/skinning.py:69", launches=lbs_launches, **lbs[512]),
        dict(name="lstm_wavefront", route="cuda", source="empose_tpu_torch/csrc/lstm_stack.cu",
             replaces="empose_tpu/ops/lstm_kernel.py:377", launches=wavefront_launches,
             **stack[(CHUNK, STREAMS)]["wavefront"]),
    ]
    # A row per (kernel, mode): the (16, 64) readings of the mode phases,
    # the training pair's at (64, 16).
    for mode in MODES:
        for kernel, source, replaces, row in (
                ("lstm_stack", "lstm_stack.cu", "lstm_kernel.py:150",
                 modes[mode]["stack"]["lstm_stack"]),
                ("lstm_wavefront", "lstm_stack.cu", "lstm_kernel.py:377",
                 modes[mode]["stack"]["lstm_wavefront"]),
                ("lstm_bidi", "lstm_bidi.cu", "lstm_kernel.py:589", modes[mode]["bidi"]),
                ("lstm_train_fwd", "lstm_train.cu", "lstm_train_kernel.py:136",
                 pair_rows[mode]["fwd"]),
                ("lstm_train_bwd", "lstm_train.cu", "lstm_train_kernel.py:244",
                 pair_rows[mode]["bwd"])):
            check(mode_launches[(kernel, mode)] > 0, f"{kernel} never launched at {mode}")
            kernels.append(dict(name=f"{kernel}@{mode}", route="cuda",
                                source=f"empose_tpu_torch/csrc/{source}",
                                replaces=f"empose_tpu/ops/{replaces}",
                                launches=mode_launches[(kernel, mode)],
                                **{k: v for k, v in row.items() if k in KERNEL_KEYS}))
    print("phases (s): " + json.dumps({k: round(v, 1) for k, v in laps.seconds.items()}),
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--step-rounding"]:
        sys.exit(step_rounding_study(seeds=range(int(sys.argv[2]) if sys.argv[2:] else 4),
                                     mode=sys.argv[3] if sys.argv[3:] else "highest",
                                     model=sys.argv[4] if sys.argv[4:] else "lgd"))
    if sys.argv[1:2] == ["--step-probe"]:
        sys.exit(step_probe(*sys.argv[2:3], *map(int, sys.argv[3:4])))
    if sys.argv[1:2] == ["--compare-pairs"]:
        sys.exit(compare_pairs(sys.argv[2:]))
    if sys.argv[1:2] == ["--time-pair"]:
        sys.exit(time_pair())
    if sys.argv[1:2] == ["--profilers"]:
        sys.exit(profilers_only())
    if sys.argv[1:2] == ["--mode-rounding"]:
        sys.exit(mode_rounding_study(seeds=range(int(sys.argv[2]) if sys.argv[2:] else 8)))
    sys.exit(main())
