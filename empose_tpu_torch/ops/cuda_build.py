"""Build the port's CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>.so`` (git-ignored) for ``sm_90a``. :func:`build` starts one
``nvcc`` per stale source, all at once, and waits for all of them;
:func:`load` builds a source if needed and returns its ``ctypes.CDLL``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Codes the kernels' C functions return beside cudaError_t values.
ERRORS = {
    -1: "the cooperative grid cannot be co-resident on this card (no units-per-block "
        "choice fits the hidden size, or the occupancy API allows too few blocks per SM)",
    -3: "the card does not support cooperative launches",
    -4: "bad shape (a size is not positive, the hidden size is not a multiple of 4, "
        "the wavefront stack has fewer than 2 layers, the launch plan does not match the "
        "kernel's layout, or the grid exceeds the launch limits)",
}

# Every source of csrc/: the libraries a run may load.
SOURCES = ("lbs", "lstm_bidi", "lstm_stack", "lstm_train")

_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def source_files(name: str) -> List[str]:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` it includes
    (``#include "..."``, followed into the headers)."""
    files, todo = [], [source_path(name)]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path) as f:
            for line in f:
                m = _INCLUDE.match(line)
                if m:
                    todo.append(os.path.join(os.path.dirname(path), m.group(1)))
    return files


def _stale(name: str) -> bool:
    """Whether the library is missing or older than its source or any header
    the source includes."""
    lib = library_path(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < max(
        os.path.getmtime(p) for p in source_files(name))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are compiled from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def build(names: Iterable[str], force: bool = False, verbose: bool = False) -> Dict[str, str]:
    """Compile ``csrc/<name>.cu`` for each name, in parallel.

    A library newer than its source and every header the source includes
    is kept unless ``force``. Returns each
    compiled name's compiler output (the ``-Xptxas -v`` register report when
    ``verbose``); raises if any compile fails."""
    procs = {}
    for name in names:
        src, lib = source_path(name), library_path(name)
        if not force and not _stale(name):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use.

    :param signatures: C function name -> (argtypes, restype).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel's C function returned anything but 0."""
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {ERRORS.get(code, f'cudaError_t {code}')}")
