"""What every driver shares: the inputs of a run, the device and its
memory, and the precision the reference runs at."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from benchmark import assets as A
from benchmark.reference import body as B

# Host streams of a seed.
BODY, SUBJECTS, DATA, SESSIONS, SAMPLE = range(5)


class Inputs:
    """The body model, subjects' offsets and weights of a run, on its device
    and written where the program reads them."""

    def __init__(self, run, device: torch.device):
        if device.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=device)
            run.phase("imports and device")
        self.npz = A.smplh_npz(A.rng_of(run.seed, BODY))
        self.subjects = A.subject_offsets(A.rng_of(run.seed, SUBJECTS))
        A.write_assets(run.tmp, self.npz, self.subjects)
        self.mod = importlib.import_module(run.config["reference"][:-3].replace("/", "."))
        self.spec = self.mod.spec(run.flags)
        self.weights = A.make_weights(self.spec, run.seed, device)
        self.device = device

    def body(self) -> B.SensorBody:
        return B.sensor_body(self.npz).to(self.device)

    def bank(self) -> Dict[str, torch.Tensor]:
        return A.offset_bank(self.subjects, self.device)

    def params(self):
        return [k for k, _, init in self.spec if A.is_parameter(init)]


def device_of(run) -> torch.device:
    return torch.device(run.device if run.device != "cuda" else "cuda:0")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(run) -> int:
    """The device allocator's peak since set-up reset it (0 on the CPU)."""
    device = device_of(run)
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def device_info(run) -> Dict:
    device = device_of(run)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": run.memory_peak}


def release(device: torch.device) -> None:
    """Free what the program left on the device before the reference runs."""
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_precision(tf32: bool) -> None:
    """float32 with TF32 off (the configuration's precision), or TF32 on
    (the control, one precision below)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
