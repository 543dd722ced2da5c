"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os

import pytest

from benchmarks.lib import device, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_cnn"}


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", sorted(_sources(spec.BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(spec.BENCH_DIR, "reference"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "tpu_cnn_torch" not in _imports(path)


def test_run_time_check_compares_whole_names():
    assert device.forbidden_loaded({"tpu_cnn_torch.ops": 1, "numpy": 1}) == []
    assert device.forbidden_loaded({"tpu_cnn.ops": 1, "jaxlib": 1}) == ["jaxlib", "tpu_cnn"]
