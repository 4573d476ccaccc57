"""The port imports neither JAX nor the JAX package, and its device-less
processes import no ``torch``.

An AST scan of every module of ``distpow_tpu_torch`` and of
``chip_smoke.py``, and a fresh interpreter that imports the port's main path
(the worker node, its CLI and RPC layer among it; the coordinator, powlib,
the client, the tracing server, trace-check and their CLIs), builds a worker
on the CPU, and finds no ``jax`` in ``sys.modules`` (this pytest process has
JAX loaded already, so the check needs its own process).  Another fresh
interpreter imports the coordinator, client, tracing-server, config-gen and
trace-check CLIs and finds no ``torch``: those processes never touch a
device; so do the stats, SLO, forensics and lint CLIs.  The lint
(``analysis/``, ``cli/lint.py``) and the lock audit (``runtime/lockcheck.py``)
import neither ``torch`` nor numpy at all.  The soak CLI imports no
``torch`` while it soaks running processes (``--addr``), and loads it when
it boots its in-process cluster (``--device cpu`` here).
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


# the lint and the lock audit run where torch may not import: stdlib only
TORCH_FREE = sorted(p for p in FILES if os.path.relpath(p, PKG).startswith("analysis" + os.sep)) + [
    os.path.join(PKG, "runtime", "lockcheck.py"), os.path.join(PKG, "cli", "lint.py")]


def test_scan_covers_the_lint_and_the_lock_audit():
    assert len(TORCH_FREE) >= 20 + 2
    assert set(TORCH_FREE) <= set(FILES)


@pytest.mark.parametrize("path", TORCH_FREE, ids=[os.path.relpath(p, REPO) for p in TORCH_FREE])
def test_lint_and_lock_audit_import_no_torch(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] in ("torch", "numpy")]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module.split(".")[0] in ("torch", "numpy"):
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
        "import distpow_tpu_torch.parallel.mesh_search, distpow_tpu_torch.tools.mesh_procs\n"
        "b.get_backend('cuda', device='cpu').search(b'\\x01', 1, range(256))\n"
        "b.get_backend('pallas-mesh', device='cpu', mesh_devices=4).search(b'\\x01', 1, "
        "range(256))\n"
        "import distpow_tpu_torch.nodes.worker, distpow_tpu_torch.cli.worker\n"
        "import distpow_tpu_torch.nodes.coordinator, distpow_tpu_torch.nodes.powlib\n"
        "import distpow_tpu_torch.nodes.client, distpow_tpu_torch.runtime.trace_server\n"
        "import distpow_tpu_torch.runtime.trace_check, distpow_tpu_torch.cluster\n"
        "import distpow_tpu_torch.fleet.membership, distpow_tpu_torch.backends.native_miner\n"
        "for cli in ('coordinator', 'client', 'tracing_server', 'config_gen', 'trace_check'):\n"
        "    __import__('distpow_tpu_torch.cli.' + cli)\n"
        "import distpow_tpu_torch.runtime.rpc as rpc\n"
        "from distpow_tpu_torch.runtime.config import WorkerConfig\n"
        "coord = rpc.RPCServer()\n"
        "addr = coord.listen('127.0.0.1:0')\n"
        "coord.serve_in_background()\n"
        "w = distpow_tpu_torch.nodes.worker.Worker(WorkerConfig(ListenAddr='127.0.0.1:0', "
        "CoordAddr=addr, BatchSize=1 << 12, WarmupNonceLens=[]), device='cpu')\n"
        "w.initialize_rpcs()\n"
        "w.shutdown()\n"
        "coord.shutdown()\n"
        "bad = sorted(m for m in set(sys.modules) - pre if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distpow_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in pre, 'jax was loaded before the port was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


DEVICE_LESS_CLIS = ("coordinator", "client", "tracing_server", "config_gen", "trace_check",
                    "stats", "slo", "forensics", "lint")


@pytest.mark.parametrize("cli", DEVICE_LESS_CLIS)
def test_device_less_clis_import_no_torch_in_a_fresh_process(cli):
    code = (
        "import sys\n"
        f"import distpow_tpu_torch.cli.{cli} as m\n"
        "assert callable(m.main)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'distpow_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_soak_cli_imports_no_torch_until_it_boots_a_cluster(tmp_path):
    from tests.test_torch_cli import PortProcStack

    stack = PortProcStack(tmp_path, workers=1, seed=99)
    try:
        stack.boot_core()
        stack.boot_port_worker(0)
        slo = os.path.join(REPO, "config", "slo.json")
        code = (
            "import sys\n"
            "def loaded():\n"
            "    return sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'distpow_tpu'))\n"
            "from distpow_tpu_torch.cli import soak\n"
            "assert not loaded(), loaded()\n"
            f"rc = soak.main(['--config', {slo!r}, '--addr', "
            f"{stack.coord_cfg['ClientAPIListenAddr']!r}, '--minutes', '0.03', "
            "'--interval', '0.5'])\n"
            "assert rc == 0, rc\n"
            "assert not loaded(), loaded()\n"
            f"rc = soak.main(['--config', {slo!r}, '--device', 'cpu', '--workers', '1', "
            "'--minutes', '0.03', '--interval', '0.5'])\n"
            "assert rc == 0, rc\n"
            "assert 'torch' in sys.modules\n"
            "assert not [m for m in loaded() if m.split('.')[0] != 'torch'], loaded()\n"
        )
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert proc.stdout.count("Soak verdict: PASS") == 2
    finally:
        stack.close()
