"""Dataset readers and batch loaders, with background prefetch (port of
``empose_tpu/data/datasets.py``): ``EMRBatchLoader`` (training batches
straight from an EMR corpus), ``EMRSequenceDataset`` (windowed sequences of
an EMR corpus), ``RealDataset`` (the ``*_clean.npz`` recordings), ``Loader``
(batches of a dataset through a collate function) and ``make_real_loader``.

Batches are the JAX package's byte for byte: the same shuffle stream (from
``seed``), the same crop stream (``window_rng``), the same time padding to a
multiple of 32. They stay numpy on the host; the trainer uploads them.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from empose_tpu_torch import constants as C
from empose_tpu_torch.data.batches import AMASSSample, RealSample, collate_real
from empose_tpu_torch.data.emr import EMRReader
from empose_tpu_torch.data.transforms import extract_window


def get_all_offset_files(data_dir: Optional[str] = None) -> Dict[str, str]:
    """{subject_id -> offset npz path} from ``*_offsets.npz`` in ``data_dir``."""
    data_dir = data_dir or C.data_dir_real()
    offset_files = sorted(glob.glob(os.path.join(data_dir, "*_offsets.npz")))
    subject_ids = [os.path.split(o)[-1].split("_")[0] for o in offset_files]
    return dict(zip(subject_ids, offset_files))


def _prefetch_iter(gen: Iterator, prefetch: int) -> Iterator:
    """Drain ``gen`` on a background thread, ``prefetch`` items ahead.

    Abandoning the iterator stops the producer: its timed ``put`` rechecks a
    stop flag. Items already drawn ahead are discarded, so an RNG owned by
    ``gen`` may have advanced up to ``prefetch + 1`` draws past the last
    consumed item. An exception in ``gen`` is raised in the consumer."""
    if prefetch <= 0:
        yield from gen
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    stop = threading.Event()

    def put_checked(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in gen:
                if not put_checked(b):
                    return
            put_checked(sentinel)
        except BaseException as e:  # raised in the consumer, not lost
            put_checked(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class EMRSequenceDataset:
    """Sequences of an EMR corpus (fields poses (F, 66), betas (10,), trans
    (F, 3), optional joints (F, 66); meta id, gender, n_frames), each cut to
    a window of ``window_size`` frames (``extract_window``: random, at the
    beginning or in the middle) or whole."""

    def __init__(self, path: str, window_size: Optional[int] = None, window_mode: str = "random",
                 rng: Optional[np.random.RandomState] = None):
        if os.path.isdir(path):
            path = os.path.join(path, "corpus.emr")
        self.reader = EMRReader(path)
        self.window_size = window_size
        self.window_mode = window_mode
        self.rng = rng

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, i: int) -> AMASSSample:
        meta = self.reader.meta(i)
        n_frames = meta["n_frames"]
        if self.window_size is not None:
            sf, ef = extract_window(n_frames, self.window_size, self.rng, self.window_mode)
        else:
            sf, ef = 0, n_frames
        r = self.reader
        return AMASSSample(meta["id"], r.read(i, "poses", sf, ef), r.read(i, "betas"),
                           r.read(i, "trans", sf, ef), fps=C.FPS,
                           joints=r.read(i, "joints", sf, ef) if "joints" in r.fields(i) else None,
                           gender=meta.get("gender", "unknown"))


class RealDataset:
    """All ``*_clean.npz`` recordings of a directory in name order, their
    sensor data normalized to the frame-0 root frame unless ``normalize`` is
    False."""

    def __init__(self, data_dir: str, normalize: bool = True):
        self.files = sorted(glob.glob(os.path.join(data_dir, "*_clean.npz")))
        if not self.files:
            raise FileNotFoundError(f"No *_clean.npz files found in {data_dir}")
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> RealSample:
        s = RealSample.from_npz_clean(self.files[i])
        return s.normalize_markers() if self.normalize else s


class Loader:
    """Batches of ``collate_fn([dataset[i], ...])``, shuffled from ``seed``
    where asked, drawn ``prefetch`` batches ahead on a background thread."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[Dict]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])

    def __iter__(self) -> Iterator[Dict]:
        yield from _prefetch_iter(self._batches(), self.prefetch)


def make_real_loader(data_dir: Optional[str] = None, batch_size: int = 1) -> Loader:
    """The real recordings of ``data_dir`` ($EM_DATA_REAL by default) in
    order, ``batch_size`` per batch."""
    return Loader(RealDataset(data_dir or C.data_dir_real()), batch_size, collate_real,
                  shuffle=False)


class EMRBatchLoader:
    """Batches of windows straight from an mmap'd EMR corpus.

    Each batch holds ``ids``, ``poses`` (B, F, 66), ``trans`` (B, F, 3),
    ``shapes`` (B, 10), ``seq_lengths`` (B,) int32 and ``joints_gt``
    (B, F, 66; zeros for corpora without joints), with F the longest window
    rounded up to ``pad_multiple``.

    :meth:`fast_forward` draws the shuffles and crops of batches a resumed
    run has already trained on without reading them, so that the next batch
    is the one an uninterrupted run would see.
    """

    def __init__(self, path: str, batch_size: int, window_size: int, shuffle: bool = True,
                 seed: int = 0, window_mode: str = "random", pad_multiple: int = 32,
                 drop_last: bool = False, window_rng: Optional[np.random.RandomState] = None,
                 prefetch: int = 0):
        if os.path.isdir(path):
            path = os.path.join(path, "corpus.emr")
        self.reader = EMRReader(path)
        self.batch_size = batch_size
        self.window_size = window_size
        self.window_mode = window_mode
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        # Crops draw from their own stream, so shuffle order and crops stay
        # independently seeded.
        self.window_rng = window_rng if window_rng is not None else self.rng
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.pad_multiple = pad_multiple
        self.n_frames = np.asarray([self.reader.meta(i)["n_frames"] for i in range(len(self.reader))])
        with_joints = sum("joints" in self.reader.fields(i) for i in range(len(self.reader)))
        if with_joints not in (0, len(self.reader)):
            raise ValueError(
                f"EMR corpus {path!r} is heterogeneous: {with_joints}/"
                f"{len(self.reader)} records have a 'joints' field; "
                "regenerate the corpus with a consistent schema.")
        self.has_joints = with_joints > 0
        self._skip = 0

    def __len__(self) -> int:
        n = len(self.reader)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _plans(self) -> Iterator:
        """One epoch of (record indices, window starts), drawing the shuffle
        first and then each batch's crops, in the JAX loader's order."""
        idx = np.arange(len(self.reader))
        if self.shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            nf = self.n_frames[chunk]
            if self.window_mode == "random":
                span = np.maximum(nf - self.window_size, 0)
                starts = (self.window_rng.rand(len(chunk)) * (span + 1)).astype(np.int64)
            elif self.window_mode == "middle":
                starts = np.maximum(nf // 2 - self.window_size // 2, 0).astype(np.int64)
            else:
                starts = np.zeros(len(chunk), np.int64)
            yield chunk, starts

    def _make_batch(self, indices: np.ndarray, starts: np.ndarray) -> Dict:
        lengths = np.minimum(self.n_frames[indices], self.window_size).astype(np.int32)
        pad_f = -(-int(lengths.max()) // self.pad_multiple) * self.pad_multiple
        r = self.reader
        batch = {
            "ids": [r.meta(int(i))["id"] for i in indices],
            "poses": r.gather_windows("poses", indices, starts, lengths, pad_f),
            "trans": r.gather_windows("trans", indices, starts, lengths, pad_f),
            "shapes": r.gather_fixed("betas", indices),
            "seq_lengths": lengths,
        }
        if self.has_joints:
            batch["joints_gt"] = r.gather_windows("joints", indices, starts, lengths, pad_f)
        else:
            batch["joints_gt"] = np.zeros((len(indices), pad_f, (C.N_JOINTS + 1) * 3), np.float32)
        return batch

    def fast_forward(self, n_batches: int) -> None:
        """Advance both random streams past ``n_batches`` batches (whole
        epochs first); the next iteration starts after them."""
        while len(self) and n_batches >= len(self):
            for _ in self._plans():
                pass
            n_batches -= len(self)
        self._skip = n_batches

    def _batches(self, skip: int) -> Iterator[Dict]:
        for k, (chunk, starts) in enumerate(self._plans()):
            if k >= skip:
                yield self._make_batch(chunk, starts)

    def __iter__(self):
        skip, self._skip = self._skip, 0
        yield from _prefetch_iter(self._batches(skip), self.prefetch)
