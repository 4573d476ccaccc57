"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Top-level module names
are compared whole: ``distpow_tpu_torch`` is not ``distpow_tpu``."""

import ast
import os
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "distpow_tpu"}
PKG = os.path.join(REPO, "portbench")


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, REPO), m) for p in _sources() for m in _imports(p)
             if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "traffic.py", "window.py", "profile.py"):
        assert not set(_imports(os.path.join(PKG, name))) - {"hashlib", "math", "random",
                                                               "bisect", "dataclasses",
                                                               "typing", "__future__", "torch"}


def test_the_harness_loads_no_jax_module():
    code = ("import sys, portbench.run, portbench.launcher, portbench.stack, "
            "portbench.faults\n"
            "from portbench import spec\n"
            "for w in ('md5-1w.d8-closed4', 'sha256d-1w.d8-closed4'):\n"
            "    spec.load(%r, w)\n"
            "from distpow_tpu_torch.nodes.powlib import POW\n"
            "from distpow_tpu_torch.cli import worker, coordinator\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (REPO, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_node_check_compares_whole_top_level_names(monkeypatch):
    import types

    from portbench.launcher import loaded_forbidden

    before = set(loaded_forbidden())
    monkeypatch.setitem(sys.modules, "distpow_tpu_torch_x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "flaxen.y", types.ModuleType("flaxen.y"))
    assert set(loaded_forbidden()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert set(loaded_forbidden()) == before | {"jax"}
