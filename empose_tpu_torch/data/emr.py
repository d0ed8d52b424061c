"""EMRecord corpora: writer, mmap reader and batched window gather in numpy
(the port's own copy of ``empose_tpu/data/emr.py``; same file format).

    [magic 'EMR1'][uint64 index_offset][record payloads ...][JSON index]

Every array field of every record is a contiguous little-endian blob whose
(offset, dtype, shape) triple is in the footer index, so any temporal window
of any field maps without touching the rest of the file. The batched gather
is the JAX package's pure-Python path; its C++ gather (``native/``) is not
ported.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

MAGIC = b"EMR1"


class EMRWriter:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self.f.write(struct.pack("<Q", 0))  # index offset placeholder
        self.index: List[Dict] = []

    def add_record(self, meta: Dict, fields: Dict[str, np.ndarray]) -> None:
        """:param meta: JSON-safe metadata (id, gender, n_frames, ...)."""
        entry = {"meta": dict(meta), "fields": {}}
        for name, arr in fields.items():
            arr = np.ascontiguousarray(arr)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            offset = self.f.tell()
            self.f.write(arr.tobytes())
            entry["fields"][name] = [offset, str(arr.dtype), list(arr.shape)]
        self.index.append(entry)

    def close(self) -> None:
        index_offset = self.f.tell()
        self.f.write(json.dumps(self.index).encode("utf-8"))
        self.f.seek(len(MAGIC))
        self.f.write(struct.pack("<Q", index_offset))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class EMRReader:
    """mmap-backed reader; windowed field reads are zero-copy views."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.mm = mmap.mmap(self.f.fileno(), 0, access=mmap.ACCESS_READ)
        if self.mm[:4] != MAGIC:
            raise ValueError(f"Not an EMR file: {path}")
        (index_offset,) = struct.unpack("<Q", self.mm[4:12])
        self.index = json.loads(self.mm[index_offset:].decode("utf-8"))

    def __len__(self) -> int:
        return len(self.index)

    def meta(self, i: int) -> Dict:
        return self.index[i]["meta"]

    def fields(self, i: int) -> List[str]:
        return list(self.index[i]["fields"].keys())

    def read(self, i: int, field: str, start: Optional[int] = None,
             end: Optional[int] = None) -> np.ndarray:
        offset, dtype, shape = self.index[i]["fields"][field]
        arr = np.frombuffer(self.mm, dtype=np.dtype(dtype), count=int(np.prod(shape)),
                            offset=offset).reshape(shape)
        if start is not None or end is not None:
            arr = arr[start:end]
        return arr

    def gather_windows(self, field: str, indices: Sequence[int], starts, n_frames,
                       pad_frames: int) -> np.ndarray:
        """Per-record temporal windows, zero-padded into (B, pad_frames, ...)."""
        _, dtype, shape = self.index[indices[0]]["fields"][field]
        out = np.zeros((len(indices), pad_frames) + tuple(shape[1:]), dtype=np.dtype(dtype))
        for k, i in enumerate(indices):
            arr = self.read(int(i), field, int(starts[k]), int(starts[k]) + int(n_frames[k]))
            out[k, : arr.shape[0]] = arr
        return out

    def gather_fixed(self, field: str, indices: Sequence[int]) -> np.ndarray:
        """A whole field per record, stacked into (B, ...)."""
        return np.stack([self.read(int(i), field) for i in indices])

    def close(self) -> None:
        self.mm.close()
        self.f.close()
