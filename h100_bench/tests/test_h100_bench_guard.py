"""Import guard: nothing the benchmark runs or imports has jax, jaxlib,
flax or mmdti_tpu as its top-level module name (mmdti_tpu_torch, whose
name begins with the JAX package's, is another name), and the reference
imports nothing of mmdti_tpu_torch."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "mmdti_tpu"}


def _imports(path):
    """Top-level names of every import in a Python file."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_h100_bench_sources_import_nothing_of_jax():
    for path in _sources(BENCH):
        assert not _imports(path) & FORBIDDEN, path


def test_h100_bench_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "mmdti_tpu_torch" not in _imports(path), path


# run in a fresh interpreter: a small CPU run of each driver path, then
# the top-level names of everything loaded
_PROGRAM = r"""
import sys
sys.path[:0] = [{root!r}, {here!r}]
from small import small_cell, CELLS
from h100_bench import run as harness
from h100_bench.registry import Registry
from h100_bench.reference import featurize, model, numerics, train
import h100_bench.control
reg = Registry()
for name in reg.names("metrics"):
    reg.metric(name)
drv = reg.driver("train")
for name in CELLS:
    drv.run(small_cell(name), 3, 0.2, False, start=harness.now(), clock=harness.now,
            device="cpu")
loaded = {{m.split(".")[0] for m in list(sys.modules)}}
print(sorted(loaded & {forbidden!r}))
print("mmdti_tpu_torch" in loaded)
"""

_REFERENCE_ONLY = r"""
import sys
sys.path[:0] = [{root!r}]
from h100_bench.reference import featurize, model, numerics, train
top = {{m.split(".")[0] for m in list(sys.modules)}}
print(sorted(top & {{"mmdti_tpu_torch", "jax", "mmdti_tpu"}}))
"""


@pytest.mark.parametrize("what", ["run", "reference"])
def test_h100_bench_loaded_modules(what):
    code = (_PROGRAM if what == "run" else _REFERENCE_ONLY).format(
        root=ROOT, here=HERE, forbidden=FORBIDDEN)
    env = {**os.environ, "MMDTI_DISABLE_FILE_LOG": "1"}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "[]", lines
    if what == "run":
        assert lines[1] == "True"   # the port itself is allowed, and was loaded
