"""The port imports neither JAX nor the JAX package.

An AST scan of every module of ``distpow_tpu_torch`` and of
``chip_smoke.py``, and a fresh interpreter that imports the port's main path
and finds no ``jax`` in ``sys.modules`` (this pytest process has JAX loaded
already, so the check needs its own process).
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distpow_tpu_torch")
# build/ holds generated output (the kernels' libraries), not the port's code
FILES = sorted(p for p in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
               if not p.startswith(os.path.join(PKG, "build") + os.sep)) + [
    os.path.join(REPO, "chip_smoke.py")]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "distpow_tpu")


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, REPO) for p in FILES])
def test_no_jax_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_catches_the_forbidden_forms():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib") and _forbidden("distpow_tpu.ops")
    assert not _forbidden("distpow_tpu_torch.ops") and not _forbidden("torch")


def test_main_path_imports_no_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        "pre = set(sys.modules)\n"
        "import distpow_tpu_torch.backends as b\n"
        "import distpow_tpu_torch.backends.cuda_backend\n"
        "import distpow_tpu_torch.parallel.search\n"
        "import distpow_tpu_torch.ops.hash_cuda, distpow_tpu_torch.ops._build\n"
        "import distpow_tpu_torch.sched.engine, distpow_tpu_torch.runtime.watchdog\n"
        "import distpow_tpu_torch.parallel.mesh_search\n"
        "b.get_backend('cuda', device='cpu').search(b'\\x01', 1, range(256))\n"
        "b.get_backend('pallas-mesh', device='cpu', mesh_devices=4).search(b'\\x01', 1, "
        "range(256))\n"
        "bad = sorted(m for m in set(sys.modules) - pre if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distpow_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in pre, 'jax was loaded before the port was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
