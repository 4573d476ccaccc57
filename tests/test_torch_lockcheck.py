"""The port's runtime lock-order audit (``distpow_tpu_torch/runtime/lockcheck.py``)
against the reference's (``distpow_tpu/runtime/lockcheck.py``).

* The reference's cases, each on a fresh copy of the port's audit loaded by
  file path (with the reference's session-wide audit, if the environment
  turned it on, stepped out of the way for the test's window): an observed
  inversion reported with its sites, a consistent order clean, RLock
  re-entry and Condition waits recording no inversion, stdlib locks not
  instrumented, held stats, install/uninstall restoring the factories.
* In fresh interpreters: the same scripted two-thread opposite-order
  program under each audit gives the same cycle of sites; the port's audit
  refuses to stack on the reference's either way round; it loads by path
  and by import without ``torch``; and ``tools/lock_audit.py`` drives the
  in-process cluster on the CPU and finds no cycle.

Locks made in this file are under the repository root, so instrumented.
"""

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_LC = os.path.join(REPO, "distpow_tpu_torch", "runtime", "lockcheck.py")
REF_LC = os.path.join(REPO, "distpow_tpu", "runtime", "lockcheck.py")
THIS = os.path.abspath(__file__)
SITE = "tests/test_torch_lockcheck.py"


def load_by_path(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def audit():
    """A fresh copy of the port's audit, installed for the test.  A
    reference audit installed session-wide (``DISTPOW_LOCK_CHECK=1``) is
    uninstalled for the window and put back after: one audit per process."""
    ref = sys.modules.get("distpow_tpu.runtime.lockcheck")
    ref_live = ref is not None and ref._installed
    if ref_live:
        ref.uninstall()
    lc = load_by_path(PORT_LC, "_port_lockcheck_under_test")
    lc.install()
    try:
        yield lc
    finally:
        lc.uninstall()
        sys.modules.pop("_port_lockcheck_under_test", None)
        if ref_live:
            ref.install()


def _ordered(a, b):
    with a:
        with b:
            pass


def scripted_inversion():
    """Two threads take two locks in opposite orders, one after the other
    (so the run cannot hang): an observed inversion."""
    a = threading.Lock()
    b = threading.Lock()
    for args in ((a, b), (b, a)):
        t = threading.Thread(target=_ordered, args=args)
        t.start()
        t.join()


def test_observed_inversion_is_reported(audit):
    scripted_inversion()
    report = audit.check()
    assert len(report.cycles) == 1
    assert all(site.startswith(SITE + ":") for site in report.cycles[0])
    text = audit.format_report(report)
    assert "inversion" in text and SITE in text


def test_consistent_order_is_clean(audit):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        _ordered(a, b)
    report = audit.check()
    assert report.cycles == []
    assert list(report.edges.values()) == [3]
    assert "clean" in audit.format_report(report)


def test_rlock_reentry_records_no_edge(audit):
    r = threading.RLock()
    with r:
        with r:
            pass
    assert audit.check().edges == {}
    assert [v["n"] for v in audit.stats().values()] == [1]


def test_condition_wait_is_not_an_inversion(audit):
    cond = threading.Condition()
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=1.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append(1)
        cond.notify_all()
    t.join()
    assert audit.check().cycles == []


def test_instrumentation_is_site_filtered(audit):
    import queue

    q = queue.Queue()  # the stdlib builds its own mutex
    q.put(1)
    assert q.get() == 1
    assert not isinstance(q.mutex, audit._LockProxy)
    lk = threading.Lock()  # built here, under the repository root
    assert isinstance(lk, audit._LockProxy)
    assert repr(lk).startswith(f"<lockcheck proxy {SITE}:")


def test_hold_stats_accumulate(audit):
    lk = threading.Lock()
    with lk:
        time.sleep(0.01)
    with lk:
        pass
    stats = audit.stats()
    (site,) = [s for s in stats if s.startswith(SITE)]
    assert stats[site]["n"] == 2
    assert stats[site]["max_s"] >= 0.01
    assert stats[site]["total_s"] >= stats[site]["max_s"]
    audit.reset()
    assert audit.stats() == {} and audit.check().edges == {}


def test_overhead_smoke(audit):
    """200k uncontended acquire/release cycles through the proxy in well
    under five seconds."""
    lk = threading.Lock()
    t0 = time.monotonic()
    for _ in range(200_000):
        with lk:
            pass
    assert time.monotonic() - t0 < 5.0


def test_uninstall_restores_real_factories(audit):
    audit.uninstall()
    assert (threading.Lock, threading.RLock, threading.Condition) == \
        (audit._real_Lock, audit._real_RLock, audit._real_Condition)
    assert not isinstance(threading.Lock(), audit._LockProxy)
    audit.install()
    audit.install()  # idempotent
    assert isinstance(threading.Lock(), audit._LockProxy)


def test_env_flag_keeps_the_references_name(monkeypatch, audit):
    assert audit.ENV_FLAG == "DISTPOW_LOCK_CHECK"
    monkeypatch.setenv("DISTPOW_LOCK_CHECK", "1")
    assert audit.enabled()
    monkeypatch.setenv("DISTPOW_LOCK_CHECK", "0")
    assert not audit.enabled()


# -- fresh interpreters ---------------------------------------------------------

def fresh(code, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DISTPOW_LOCK_CHECK", None)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


LOAD = (
    "import importlib.util, json, runpy, sys\n"
    "def load(path, name):\n"
    "    spec = importlib.util.spec_from_file_location(name, path)\n"
    "    m = importlib.util.module_from_spec(spec)\n"
    "    sys.modules[name] = m\n"
    "    spec.loader.exec_module(m)\n"
    "    return m\n"
)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_scripted_program_gives_the_same_cycle_under_each_audit(which):
    path, name = {"reference": (REF_LC, "distpow_tpu.runtime.lockcheck"),
                  "port": (PORT_LC, "distpow_tpu_torch.runtime.lockcheck")}[which]
    code = LOAD + (
        f"lc = load({path!r}, {name!r})\n"
        "lc.install()\n"
        f"runpy.run_path({THIS!r})['scripted_inversion']()\n"
        "r = lc.check()\n"
        "print(json.dumps({'cycles': r.cycles, 'edges': sorted(map(list, r.edges)),\n"
        "                  'held': sorted(lc.stats())}))\n"
    )
    proc = fresh(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    src, start = inspect.getsourcelines(scripted_inversion)
    a, b = (f"{SITE}:{start + i}" for i, line in enumerate(src) if "threading.Lock()" in line)
    assert got == {"cycles": [sorted([a, b])], "edges": [[a, b], [b, a]],
                   "held": sorted([a, b])}


@pytest.mark.parametrize("order", ["reference-first", "port-imported-first"])
def test_two_audits_in_one_process_are_refused(order):
    steps = {
        "reference-first": (
            f"ref = load({REF_LC!r}, 'distpow_tpu.runtime.lockcheck')\n"
            "ref.install()\n"
            "from distpow_tpu_torch.runtime import lockcheck as port\n"),
        "port-imported-first": (
            "from distpow_tpu_torch.runtime import lockcheck as port\n"
            f"ref = load({REF_LC!r}, 'distpow_tpu.runtime.lockcheck')\n"
            "ref.install()\n"),
    }[order]
    code = LOAD + steps + (
        "try:\n"
        "    port.install()\n"
        "except RuntimeError as exc:\n"
        "    print('refused:', exc)\n"
        "else:\n"
        "    sys.exit('installed on top of the reference audit')\n"
        "assert not port._installed\n"
        "ref.uninstall()\n"
        "import threading\n"
        "assert threading.Lock is ref._real_Lock\n"
    )
    proc = fresh(code)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "refused: lockcheck: threading's lock factories are already patched" in proc.stdout
    assert "fresh interpreter" in proc.stdout


@pytest.mark.parametrize("how", ["by-path", "import"])
def test_loads_standalone_without_torch(how):
    get = {"by-path": f"lc = load({PORT_LC!r}, 'distpow_tpu_torch.runtime.lockcheck')\n",
           "import": "from distpow_tpu_torch.runtime import lockcheck as lc\n"}[how]
    code = LOAD + get + (
        "lc.install()\n"
        "import threading\n"
        "assert threading.Lock is not lc._real_Lock\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'distpow_tpu', 'numpy'))\n"
        "assert not bad, bad\n"
        "from distpow_tpu_torch.runtime import metrics\n"
        "assert isinstance(metrics.REGISTRY._lock, lc._LockProxy), metrics.REGISTRY._lock\n"
        "assert 'torch' not in sys.modules\n"
        "lc.uninstall()\n"
    )
    proc = fresh(code)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_lock_audit_driver_on_the_cpu_finds_no_cycle():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DISTPOW_LOCK_CHECK", None)
    proc = subprocess.run(
        [sys.executable, "-m", "distpow_tpu_torch.tools.lock_audit", "--backend", "python",
         "--device", "cpu", "--workers", "2",
         "--concurrent", "01020304:2", "05060708:1", "02020202:1", "02020202:2",
         "--sequential", "01020305:1", "01020306:2", "05060709:1", "02020203:2",
         "--duration-s", "1.5", "--difficulty", "2:1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    audit = out["audit"]
    assert audit["cycles"] == [] and audit["edges"] > 0
    assert audit["port_sites_held"] > 5
    for key in ("top_total_s", "top_max_s"):
        assert len(audit[key]) == 5
        assert all(":" in r["site"] and r["n"] > 0 for r in audit[key])
    assert audit["top_total_s"][0]["total_s"] >= audit["top_total_s"][-1]["total_s"]
    assert len(out["demo_requests"]["concurrent"]["client_ms"]) == 4
    assert len(out["demo_requests"]["sequential"]["client_ms"]) == 4
    assert out["load"]["errors"] == 0 and out["load"]["completed"] == out["load"]["offered"] > 0
    assert out["kernel_launches"] == {}  # the python backend launches no kernel
