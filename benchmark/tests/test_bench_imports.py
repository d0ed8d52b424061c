"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name; the reference imports nothing of the program."""

import ast
import os

from benchmark import harness
from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
OFF_LIMITS = ("bench", "tools", "scripts", "native", "__graft_entry__", "chip_smoke")


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_in_the_benchmark():
    for path in sources():
        for name in imported(path):
            top = name.split(".")[0]
            assert top not in harness.FORBIDDEN, (path, name)
            assert top not in OFF_LIMITS, (path, name)
            assert not name.startswith("empose_tpu_torch.tools"), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in imported(path):
            assert name.split(".")[0] != "empose_tpu_torch", (path, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), \
                (path, name)


def test_top_level_names_are_compared_whole(monkeypatch):
    import sys
    for name, bad in (("empose_tpu_torch.serve", False), ("empose_tpu", True),
                      ("empose_tpu.nn.models", True), ("jax.numpy", True), ("jaxlib", True),
                      ("flax", True), ("jaxtyping", False), ("flaxen", False)):
        monkeypatch.setitem(sys.modules, name, object())
        assert (name in harness.forbidden_modules()) == bad, name
        monkeypatch.delitem(sys.modules, name)
