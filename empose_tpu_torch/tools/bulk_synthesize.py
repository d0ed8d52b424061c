"""Bulk sensor-data synthesis: mocap corpus -> training-ready EMR (port of
``tools/bulk_synthesize.py``).

Materializes the synthetic EM measurements (normalize root -> FK + virtual
sensors -> mounting offsets) on the device. Each pass draws one random
window per corpus sequence (``--passes N`` for more); records carry the
training batch's fields (marker_pos/marker_ori/marker_nor, poses with the
root normalized, shapes, zeroed trans, joints, offset_t/offset_r), so a
consumer can assemble model-ready batches without further synthesis.

    python -m empose_tpu_torch.tools.bulk_synthesize --corpus $EM_DATA_SYNTH/amass_emr \\
        --out /tmp/materialized.emr --window 64 [--offset_noise_level -1..3] \\
        [--dp_devices N] [--device cpu]

The windows come from ``EMRBatchLoader`` seeded ``--seed`` (the JAX tool's
windows for the same seed). The offset draws (a subject per window, and the
normals of levels 0 and 1) come from a CPU ``torch.Generator`` seeded
``--seed`` at each whole batch, so the records are the same on any device
and for any ``--dp_devices``. ``--dp_devices N`` pads each batch to a
multiple of N (``parallel/mesh.pad_batch_to_devices``) and synthesizes
shard r on the r-th device of ``make_mesh(N)`` (the CPU N times with
``--device cpu``); pads are not written. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.data import transforms as T
from empose_tpu_torch.data.batches import to_device
from empose_tpu_torch.data.datasets import EMRBatchLoader, get_all_offset_files
from empose_tpu_torch.data.emr import EMRWriter
from empose_tpu_torch.device import resolve_device
from empose_tpu_torch.nn.models import SensorSMPL
from empose_tpu_torch.parallel import mesh as M

FIELDS = ("marker_pos", "marker_ori", "marker_nor", "joints_gt", "poses", "trans", "offset_t",
          "offset_r")


def synthesize_corpus(corpus_path: str, out_path: str, window: int = 64, batch: int = 32,
                      noise_level: int = 0, seed: int = 0, dp_devices: int = 1,
                      passes: int = 1, device=None) -> int:
    """Write ``passes`` windows of every sequence of ``corpus_path`` with their
    synthetic sensors to ``out_path``; returns the number of records."""
    dev_type = resolve_device(device).type
    devices = M.make_mesh(dp_devices, dev_type) if dp_devices > 1 else [resolve_device(device)]
    smplh = load_smplh()
    offset_files = list(get_all_offset_files().values())
    per_device = {}
    for d in dict.fromkeys(devices):
        per_device[d] = (SensorSMPL(smplh).to(d),
                         T.OffsetBank.from_offset_files(offset_files, device=d))
    bank_cpu = T.OffsetBank.from_offset_files(offset_files)
    randomize = noise_level >= 0
    generator = torch.Generator().manual_seed(seed)

    def synth(host, s_idx, z, d):
        sensor, bank = per_device[d]
        b = T.normalize_root(to_device(host, d))
        b = T.smpl_fk_markers(sensor, b)
        b = T.sample_markers_with_offsets(b, bank, s_idx.to(d),
                                          None if z is None else z.to(d), noise_level, randomize)
        return {k: b[k] for k in FIELDS}

    loader = EMRBatchLoader(corpus_path, batch, window, shuffle=False, seed=seed,
                            pad_multiple=window)
    count, t0 = 0, time.time()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with EMRWriter(out_path) as w:
        for _pass in range(passes):
            for host_batch in loader:
                ids = host_batch["ids"]
                n, f = host_batch["poses"].shape[:2]
                lengths = np.asarray(host_batch["seq_lengths"])
                shapes = np.asarray(host_batch["shapes"])
                s_idx, z = T.draw_offset_noise(bank_cpu, n, f, generator, noise_level, randomize)
                padded = M.pad_batch_to_devices(host_batch, len(devices))
                n_padded = padded["poses"].shape[0]
                issued = []  # every shard's synthesis is issued before the first download
                for r, d in enumerate(devices):
                    rows = M.Shard(r, len(devices), n, n_padded).samples("cpu")
                    issued.append(synth(M.shard_batch(padded, r, len(devices)), s_idx[rows],
                                        None if z is None else z[rows], d))
                out = {k: np.concatenate([o[k].cpu().numpy() for o in issued])[:n]
                       for k in FIELDS}
                for i, seq_id in enumerate(ids):
                    L = int(lengths[i])
                    w.add_record(
                        {"id": f"{seq_id}@w{count + i}", "n_frames": L},
                        {"marker_pos": out["marker_pos"][i, :L],
                         "marker_ori": out["marker_ori"][i, :L],
                         "marker_nor": out["marker_nor"][i, :L],
                         "joints": out["joints_gt"][i, :L],
                         "poses": out["poses"][i, :L],
                         "trans": out["trans"][i, :L],
                         "betas": shapes[i],
                         "offset_t": out["offset_t"][i],
                         "offset_r": out["offset_r"][i]})
                count += len(ids)
    dt = time.time() - t0
    print(f"Synthesized {count} windows x {window} frames in {dt:.1f}s "
          f"({count * window / dt:,.0f} frames/s) -> {out_path}")
    return count


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m empose_tpu_torch.tools.bulk_synthesize")
    p.add_argument("--corpus", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--offset_noise_level", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp_devices", type=int, default=1)
    p.add_argument("--passes", type=int, default=1, help="Random window draws per sequence.")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default) or cpu.")
    return p


def main(argv: Optional[list] = None) -> int:
    args = parser().parse_args(argv)
    return synthesize_corpus(args.corpus, args.out, args.window, args.batch,
                             args.offset_noise_level, args.seed, args.dp_devices, args.passes,
                             args.device)


if __name__ == "__main__":
    main()
