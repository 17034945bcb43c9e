"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their top-level name, whole: ``multimodal_decoding_tpu_torch`` (the port)
begins with ``multimodal_decoding_tpu`` (the JAX package) and is not it."""

from __future__ import annotations

import ast
import os

import pytest

from portbench.harness import bench

PORT = "multimodal_decoding_tpu_torch"


def imported(path: str) -> set:
    """Top-level names of every module ``path`` imports, anywhere in it."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = "") -> list:
    top = os.path.join(bench.BENCH_DIR, sub)
    return sorted(os.path.join(b, f) for b, _, fs in os.walk(top) for f in fs
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, bench.ROOT))
def test_no_jax(path):
    assert not imported(path) & set(bench.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, bench.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {PORT}
    assert imported(path) <= {"__future__", "numpy", "torch", "portbench"}


def test_whole_names_are_compared():
    assert bench.forbidden_loaded([PORT, f"{PORT}.ops", "jaxtyping", "numpy"]) == []
    assert bench.forbidden_loaded(["jax.numpy", "multimodal_decoding_tpu.ops", "flax"]) == [
        "flax", "jax.numpy", "multimodal_decoding_tpu.ops"]


def test_reference_uses_only_the_reference():
    for path in sources("reference"):
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("portbench"):
                assert node.module == "portbench.reference", (path, node.module)
