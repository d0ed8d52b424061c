"""The port's nvcc build bookkeeping (``empose_tpu_torch/ops/cuda_build.py``)
on the CPU: which files a source's library depends on, and when it is stale.
No compiler runs here."""

import os

import pytest

from empose_tpu_torch.ops import cuda_build


def test_stack_source_includes_common_header():
    """The three LSTM kernels' libraries (stack, bidirectional layer,
    training pair) depend on their source and the shared device helpers;
    the LBS kernel, which shares none, depends on its source alone."""
    for name in ("lstm_stack", "lstm_bidi", "lstm_train"):
        files = [os.path.basename(f) for f in cuda_build.source_files(name)]
        assert files == [f"{name}.cu", "lstm_common.cuh"]
    assert [os.path.basename(f) for f in cuda_build.source_files("lbs")] == ["lbs.cu"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    return csrc, build


def _touch(path, t):
    os.utime(path, (t, t))


def test_library_stale_when_any_included_header_is_newer(tree):
    """A library older than its source or than any header the source
    includes, directly or through another header, is rebuilt; one newer
    than all of them is kept."""
    csrc, build = tree
    assert [os.path.basename(f) for f in cuda_build.source_files("k")] == ["k.cu", "a.cuh",
                                                                           "b.cuh"]
    assert cuda_build._stale("k")  # no library yet
    lib = build / "libk.so"
    lib.write_bytes(b"")
    for f in ("k.cu", "a.cuh", "b.cuh"):
        _touch(csrc / f, 1000)
    _touch(lib, 2000)
    assert not cuda_build._stale("k")
    for f in ("k.cu", "a.cuh", "b.cuh"):
        _touch(csrc / f, 3000)
        assert cuda_build._stale("k"), f
        _touch(csrc / f, 1000)
    assert cuda_build.build(["k"]) == {}  # up to date: no nvcc started


def test_sources_are_every_kernel_source():
    """``SOURCES``, which the data-parallel train CLI builds before it
    spawns its ranks, names every ``csrc/*.cu``."""
    names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
    assert list(cuda_build.SOURCES) == names
