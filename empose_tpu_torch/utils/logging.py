"""Scalar logging and step timing (port of ``empose_tpu/utils/logging.py``).

Every scalar lands in ``scalars.jsonl`` in the log directory, and in
tensorboardX event files when that package is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self.jsonl.write(json.dumps({"tag": tag, "value": value, "step": int(step),
                                     "time": time.time()}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def add_scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def flush(self) -> None:
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self) -> None:
        self.flush()
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class StepTimer:
    """Wall-clock timer; ``reset`` returns the seconds since the last reset."""

    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def reset(self) -> float:
        e = self.elapsed()
        self.start = time.time()
        return e
