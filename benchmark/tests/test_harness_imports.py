"""No module under `benchmark/` imports JAX or the JAX package (top-level
names compared whole: `paths_tpu_torch` is not `paths_tpu`), and the
reference imports nothing of the program under test."""
from __future__ import annotations

import ast
import contextlib
import os
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "paths_tpu"}


def _modules():
    for base, _, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_module_imports_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref, f)))
            assert "paths_tpu_torch" not in tops, f
            assert not tops & FORBIDDEN, f


def test_top_level_names_compare_whole():
    assert "paths_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "paths_tpu.config".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("loads_jax", [False, True])
def test_jax_loaded_by_a_reader_leaves_no_result(loads_jax, tmp_path, monkeypatch):
    """The look into `sys.modules` comes after the check and every per-layer
    reader: a reader that loads JAX leaves the run without a result."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))

    @contextlib.contextmanager
    def untraced(run, out):
        yield

    def reader(metric):
        def read(layer):
            if loads_jax:
                monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return 1.0
        return read

    monkeypatch.setattr(harness, "traced_segment", untraced)
    monkeypatch.setattr(harness, "reader", reader)
    cfg, tr = tiny.brca("requests_repeat")
    cell = "brca.predict-cached"
    if loads_jax:
        with pytest.raises(SystemExit):
            tiny.run(cell, cfg, tr, trace=True, cache=str(tmp_path))
    else:
        out = tiny.run(cell, cfg, tr, trace=True, cache=str(tmp_path))
        assert out["correct"] and out["metrics"]
        assert all(m["value"] == 1.0 for m in out["metrics"].values())
