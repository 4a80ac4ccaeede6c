"""Nothing the harness, the references, the metrics or the work counts
import is JAX or the JAX package; the references import nothing of the
program either.  Top-level module names are compared whole."""

import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

import run

JAX_NAMES = {"jax", "jaxlib", "flax", "ofdm_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(*subdirs):
    return [p for d in subdirs for p in glob.glob(os.path.join(BENCH_DIR, d, "*.py"))]


def test_no_source_names_jax_or_the_jax_package():
    for path in _sources("", "harness", "reference", "metrics", "work"):
        assert not _top_level_imports(path) & JAX_NAMES, path


def test_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert not _top_level_imports(path) & (JAX_NAMES | {"ofdm_tpu_torch"}), path


def test_loaded_modules_hold_no_jax():
    """Import every harness, reference, metric and work module and the
    program's entry points in a fresh interpreter, then read sys.modules."""
    code = f"""
import glob, os, sys
sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}]
from harness import check, peaks, program, spec, trace, traffic
for d in ("reference", "metrics", "work"):
    for p in sorted(glob.glob(os.path.join({BENCH_DIR!r}, d, "*.py"))):
        spec.load_module(p)
from ofdm_tpu_torch.pipeline import LinkRunner, prepare
import run
print(" ".join(run.forbidden_modules()) or "none")
print(" ".join(sorted({{m.split('.')[0] for m in sys.modules}} & {{'ofdm_tpu_torch', 'bench_reference_ofdm_link_py'}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={k: v for k, v in os.environ.items() if not k.startswith("JAX")})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == "none"
    assert lines[1] == "bench_reference_ofdm_link_py ofdm_tpu_torch"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ofdm_tpu_torch_shadow", sys)
    assert "ofdm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ofdm_tpu.ops", sys)
    assert run.forbidden_modules() == ["ofdm_tpu"]
