"""The PyTorch port stands alone: no jax, no empose_tpu, CUDA unless asked otherwise."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "empose_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'empose_tpu' or m.startswith('empose_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_full_mesh_datagen_and_bench_modules_are_covered():
    """The full-mesh, datagen and bench modules are among those the
    no-jax check above imports."""
    assert {"empose_tpu_torch.preprocess", "empose_tpu_torch.eval.harness",
            "empose_tpu_torch.tools.bench_lstm_kernels", "empose_tpu_torch.ops.skinning",
            "empose_tpu_torch.ops.quaternions"} <= set(_port_modules())


def test_port_sources_never_import_jax_or_reference():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+empose_tpu\b(?!_torch)"
                         r"|from\s+empose_tpu\b(?!_torch))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


def test_resolve_device():
    from empose_tpu_torch.device import resolve_device, set_precision
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
    from empose_tpu_torch.nn.layers import nn_precision
    from empose_tpu_torch.nn.models import fk_precision
    try:
        set_precision("default")  # the bf16 serving mode binds both knobs, TF32 stays off
        assert (nn_precision(), fk_precision()) == ("default", "default")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        with pytest.raises(ValueError, match="unknown precision"):
            set_precision("bf16")
    finally:
        set_precision("highest")
    assert (nn_precision(), fk_precision()) == ("highest", "highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_eval_modules_are_covered_and_import_no_jax_or_tabulate():
    """The real-data eval modules are walked by the checks above, and they
    import neither jax, the JAX package nor tabulate (the card's machine
    has no tabulate; the port formats its tables itself)."""
    new = ["empose_tpu_torch.eval.metrics", "empose_tpu_torch.eval.cli",
           "empose_tpu_torch.eval.harness", "empose_tpu_torch.data.batches",
           "empose_tpu_torch.data.datasets"]
    assert set(new) <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {new!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'empose_tpu', 'tabulate'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_parallel_and_new_tool_modules_are_covered():
    """Data parallelism and the serving, datagen and multi-process tools are
    among the modules the no-jax checks above import."""
    assert {"empose_tpu_torch.parallel.mesh", "empose_tpu_torch.tools.bench_serve",
            "empose_tpu_torch.tools.bulk_synthesize",
            "empose_tpu_torch.tools.multihost_worker"} <= set(_port_modules())


def test_asset_writer_and_gate_modules_are_covered():
    """The asset writer, the three training gates and their shared helpers
    are among the modules the no-jax checks above import."""
    assert {"empose_tpu_torch.tools.make_synthetic_assets",
            "empose_tpu_torch.tools.convergence_gate", "empose_tpu_torch.tools.demo_convergence",
            "empose_tpu_torch.tools.demo_resume",
            "empose_tpu_torch.tools.gate_common"} <= set(_port_modules())


def test_profiler_modules_are_covered_and_import_no_jax_tool():
    """The profilers, ``measure_remat`` and their helpers are among the
    modules the no-jax checks above import, and importing them loads
    neither ``bench``, ``__graft_entry__`` nor the JAX package's ``tools``."""
    new = [f"empose_tpu_torch.tools.{m}" for m in (
        "profile_common", "profile_fk", "profile_forward", "profile_train", "profile_backward",
        "measure_remat")]
    assert set(new) <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {new!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'empose_tpu', 'bench', '__graft_entry__', 'tools'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
