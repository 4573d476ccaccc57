"""The port's distpow-lint (``distpow_tpu_torch/analysis``, ``cli/lint.py``)
against the reference's (``distpow_tpu/analysis``, ``scripts/lint.py``).

* Parity: over the reference's fixture corpus and over the port's own tree,
  both engines give the same ``(rule, path, line)`` findings and the same
  suppressed ones, each tree's messages equal too, except where named: the
  two device rules (``hot-path-host-sync``, ``relaunch-loop-sync``) are
  written in PyTorch's terms in the port, so their advice text differs,
  and over the port's tree the reference's JAX-terms rule flags host numpy
  casts in ``ops/operands.py`` and misses the torch syncs the port's rule
  finds (which the port's tree suppresses, so the reference calls those
  suppressions unused).  With the port's own context (no compile cache),
  the reference's ``compile_cache.*`` fixture names are undeclared.
* Every rule fires on each bad fixture of the reference's cases with the
  same count and passes each ok one; the suppression protocol behaves as
  the reference's.
* The device rules on torch fixtures written from strings: every idiom
  they flag, and the host-side forms they must not flag.
* The port's tree is clean with at least 10 justified suppressions, its
  context parses from its own declarations, and the CLI keeps the
  reference CLI's options and exit codes in a process that loads neither
  ``torch`` nor ``jax``.

Tier-1 (``lint`` marker, un-slow): stdlib AST work.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

from distpow_tpu.analysis import build_context as ref_build_context
from distpow_tpu.analysis import run_analysis as ref_run_analysis
from distpow_tpu.analysis.rules import ALL_RULES as REF_RULES
from distpow_tpu_torch.analysis import PACKAGE_ROOT, build_context, run_analysis
from distpow_tpu_torch.analysis.engine import BARE_SUPPRESSION, UNUSED_SUPPRESSION
from distpow_tpu_torch.analysis.rules import ALL_RULES
from tests.test_lint import CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(REPO, "distpow_tpu")
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
CTX = build_context()
DEVICE_RULES = ("hot-path-host-sync", "relaunch-loop-sync")
TORCH_SYNCS = (".item()", ".tolist()", ".cpu()", ".numpy()", ".synchronize()")

pytestmark = pytest.mark.lint


def keys(findings, with_message=True):
    return sorted((f.rule, f.path, f.line, f.message if with_message else "")
                  for f in findings)


def suppressed_keys(report):
    return sorted((f.rule, f.path, f.line) for f, _ in report.suppressed)


@functools.lru_cache(maxsize=None)
def tree_reports():
    """Both engines over the port's tree, each with the port's context
    parsed by its own ``build_context``: (reference's, port's)."""
    ref = ref_run_analysis([PACKAGE_ROOT], context=ref_build_context(PACKAGE_ROOT), rel_to=REPO)
    port = run_analysis([PACKAGE_ROOT], context=CTX, rel_to=REPO)
    return ref, port


def lint(path, rule=None, context=CTX):
    return run_analysis([os.path.join(FIXTURES, path)], context=context,
                        rule_ids=[rule] if rule else None, rel_to=REPO)


# -- parity with the reference ------------------------------------------------

def compare(ref_findings, port_findings):
    """Same (rule, path, line) everywhere; the same message except for the
    device rules' advice text."""
    assert keys(ref_findings, False) == keys(port_findings, False)
    strip = [(r, p, ln, m) for r, p, ln, m in keys(ref_findings) if r not in DEVICE_RULES]
    assert strip == [(r, p, ln, m) for r, p, ln, m in keys(port_findings)
                     if r not in DEVICE_RULES]


def test_fixture_corpus_gives_the_reference_findings():
    ref = ref_run_analysis([FIXTURES], context=ref_build_context(REF_PKG), rel_to=REPO)
    port = run_analysis([FIXTURES], context=build_context(REF_PKG), rel_to=REPO)
    assert len(ref.findings) > 50
    compare(ref.findings, port.findings)
    assert suppressed_keys(ref) == suppressed_keys(port)
    assert ref.checked_files == port.checked_files
    # the device rules' findings are among them, at the same lines
    assert {f.rule for f in port.findings} >= set(DEVICE_RULES)


def test_fixture_corpus_under_the_ports_own_context():
    """The one difference the port's context makes: it declares no
    ``compile_cache.*`` counter (the port has no JAX compilation cache)."""
    ref = ref_run_analysis([FIXTURES], context=ref_build_context(REF_PKG), rel_to=REPO)
    port = run_analysis([FIXTURES], context=CTX, rel_to=REPO)
    extra = sorted(set(keys(port.findings, False)) - set(keys(ref.findings, False)))
    assert extra and set(keys(ref.findings, False)) <= set(keys(port.findings, False))
    for rule, path, _line, _ in extra:
        assert (rule, path) == ("metrics-registry", "tests/lint_fixtures/metrics_registry_ok.py")
    assert all("compile_cache." in f.message for f in port.findings
               if (f.rule, f.path) == ("metrics-registry",
                                       "tests/lint_fixtures/metrics_registry_ok.py"))


def test_port_tree_gives_the_reference_findings_but_the_device_rules():
    ref, port = tree_reports()
    assert ref.checked_files == port.checked_files

    def device_bound(f):
        return f.rule in DEVICE_RULES or (
            f.rule == UNUSED_SUPPRESSION and any(r in f.message for r in DEVICE_RULES))

    assert keys(f for f in ref.findings if not device_bound(f)) == \
        keys(f for f in port.findings if not device_bound(f))
    assert sorted(k for k in suppressed_keys(ref) if k[0] not in DEVICE_RULES) == \
        sorted(k for k in suppressed_keys(port) if k[0] not in DEVICE_RULES)
    # the stated differences: the reference's rule flags host numpy casts to
    # a numpy dtype (its advice, jnp, does not exist here) ...
    src = {}
    for f in ref.findings:
        if not device_bound(f):
            continue
        if f.rule == "hot-path-host-sync":
            lines = src.setdefault(f.path, open(os.path.join(REPO, f.path)).read().split("\n"))
            assert f.message.startswith(("np.asarray", "np.array")), f.format()
            assert "dtype=np." in lines[f.line - 1], f.format()
        else:
            # ... and calls the port's suppressions of torch syncs unused
            assert f.rule == UNUSED_SUPPRESSION and "hot-path-host-sync" in f.message, f.format()
    ref_only = set(suppressed_keys(port)) - set(suppressed_keys(ref))
    assert ref_only and all(k[0] == "hot-path-host-sync" for k in ref_only)
    for f, sup in port.suppressed:
        if (f.rule, f.path, f.line) in ref_only:
            assert f.message.startswith(TORCH_SYNCS), f.format()
            assert sup.justification


# -- every rule fires and passes ----------------------------------------------

def test_rule_catalog_is_the_references():
    assert [r.RULE_ID for r in ALL_RULES] == [r.RULE_ID for r in REF_RULES]
    assert len(ALL_RULES) == 17
    ref_by_id = {r.RULE_ID: r for r in REF_RULES}
    for rule in ALL_RULES:
        if rule.RULE_ID not in DEVICE_RULES:
            assert rule.DESCRIPTION == ref_by_id[rule.RULE_ID].DESCRIPTION


@pytest.mark.parametrize("rule,bad,ok,n_expected", CASES,
                         ids=[f"{c[0]}-{os.path.dirname(c[1]) or 'top'}" for c in CASES])
def test_rule_fires_and_passes(rule, bad, ok, n_expected):
    ref_ctx = build_context(REF_PKG)
    bad_report = lint(bad, rule, ref_ctx)
    assert len(bad_report.findings) == n_expected, \
        "\n".join(f.format() for f in bad_report.findings)
    assert all(f.rule == rule for f in bad_report.findings)
    ok_report = lint(ok, rule, ref_ctx)
    assert ok_report.findings == [], "\n".join(f.format() for f in ok_report.findings)


def test_blocking_under_lock_flags_each_blocking_kind():
    lines = {f.line for f in lint("blocking_under_lock_bad.py",
                                  "no-blocking-under-lock").findings}
    assert lines == {19, 23, 24, 28, 29}


@pytest.mark.parametrize("root,rules", [("dead_pkg_bad", ["dead-package"]),
                                        ("dead_pkg_ok", [])])
def test_dead_package_rule(root, rules):
    report = run_analysis([os.path.join(FIXTURES, root)], context=CTX, rel_to=REPO)
    assert [f.rule for f in report.findings] == rules


@pytest.mark.parametrize("fixture,rules,n_suppressed", [
    ("suppressed_ok.py", [], 1),
    ("suppressed_bare.py", [BARE_SUPPRESSION], 0),
    ("suppressed_unused.py", [UNUSED_SUPPRESSION], 0),
])
def test_suppression_protocol(fixture, rules, n_suppressed):
    report = lint(fixture)
    assert [f.rule for f in report.findings] == rules
    assert len(report.suppressed) == n_suppressed
    if n_suppressed:
        finding, sup = report.suppressed[0]
        assert finding.rule == "no-blocking-under-lock"
        assert "documented design" in sup.justification


def test_single_rule_run_does_not_flag_foreign_suppressions():
    report = run_analysis([os.path.join(PACKAGE_ROOT, "nodes")], context=CTX,
                          rule_ids=["silent-except"], rel_to=REPO)
    assert report.findings == [], [f.format() for f in report.findings]


def test_trailing_suppression_covers_wrapped_call(tmp_path):
    p = tmp_path / "wrapped.py"
    p.write_text(
        "import threading, time\n"
        "_lock = threading.Lock()\n"
        "def f(x):\n"
        "    with _lock:\n"
        "        time.sleep(\n"
        "            x)  # distpow: ok no-blocking-under-lock -- "
        "deliberate hold, fixture\n"
    )
    report = run_analysis([str(p)], context=CTX)
    assert report.findings == [], [f.format() for f in report.findings]
    assert len(report.suppressed) == 1


# -- the device rules on torch fixtures ----------------------------------------

HOT_BAD = '''
import numpy as np
import torch


def drain(res, event, stream, t):
    a = res.item()
    b = res.tolist()
    c = res.cpu()
    d = res.numpy()
    event.synchronize()
    stream.synchronize()
    torch.cuda.synchronize()
    torch.cuda.synchronize(t.device)
    e = np.asarray(res)
    f = np.array(res[0])
    g = np.asarray(t, np.uint32)
    return a, b, c, d, e, f, g
'''
HOT_BAD_LINES = [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

HOT_OK = '''
import numpy as np
import torch


def stage(rows, values, res, event, host):
    a = np.asarray([1, 2, 3], dtype=np.uint32)
    b = np.array((4, 5))
    c = np.asarray(rows, dtype=np.uint32)
    d = np.array([v & 0xFFFFFFFF for v in values])
    e = np.asarray(values, dtype=np.int32)
    f = torch.as_tensor(values)
    g = res.to("cpu", non_blocking=True)
    h = host.copy_(res, non_blocking=True)
    done = event.query()
    event.record()
    return a, b, c, d, e, f, g, h, done
'''

RELAUNCH_BAD = '''
def loops(results, res, step, n):
    out = []
    for r in results:
        out.append(r.item())
    firsts = [x.item() for x in results]
    while n:
        out.append(int(res))
        n -= 1
    for i in range(n):
        out.append(int(res[i]))
    return out, firsts, {k: v.item() for k, v in step}
'''
RELAUNCH_BAD_LINES = [4, 5, 7, 10, 11]

RELAUNCH_OK = '''
def drains(inflight, results, n, event):
    res = inflight.popleft()
    first = res.item()
    for r in results:
        n += int(len(r))
        n += int(r.shape[0] + 1)
        host = r.tolist()
        pairs = dict(r.items())
        event.query()

    def drain_one(x):
        return x.item()
    return first, host, pairs, n, drain_one
'''


def write(tmp_path, rel, text):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text).lstrip("\n"))
    return str(path)


@pytest.mark.parametrize("rule,rel,text,lines", [
    ("hot-path-host-sync", "ops/bad.py", HOT_BAD, HOT_BAD_LINES),
    ("hot-path-host-sync", "parallel/search.py", HOT_BAD, HOT_BAD_LINES),
    ("hot-path-host-sync", "ops/ok.py", HOT_OK, []),
    ("hot-path-host-sync", "parallel/other.py", HOT_BAD, []),
    ("relaunch-loop-sync", "parallel/bad.py", RELAUNCH_BAD, RELAUNCH_BAD_LINES),
    ("relaunch-loop-sync", "sched/bad.py", RELAUNCH_BAD, RELAUNCH_BAD_LINES),
    ("relaunch-loop-sync", "parallel/ok.py", RELAUNCH_OK, []),
    ("relaunch-loop-sync", "ops/bad.py", RELAUNCH_BAD, []),
], ids=["hot-ops", "hot-driver", "hot-host-forms", "hot-out-of-scope", "relaunch-parallel",
        "relaunch-sched", "relaunch-host-forms", "relaunch-out-of-scope"])
def test_device_rules_on_torch_idioms(tmp_path, rule, rel, text, lines):
    path = write(tmp_path, rel, text)
    report = run_analysis([path], context=CTX, rule_ids=[rule])
    assert sorted(f.line for f in report.findings) == lines, \
        "\n".join(f.format() for f in report.findings)
    assert all(f.rule == rule for f in report.findings)
    for f in report.findings:
        assert "jnp" not in f.message


def test_device_rule_messages_advise_the_ports_drain(tmp_path):
    path = write(tmp_path, "ops/bad.py", HOT_BAD)
    messages = {f.line: f.message for f in run_analysis(
        [path], context=CTX, rule_ids=["hot-path-host-sync"]).findings}
    assert messages[6].startswith(".item()") and "CUDA event" in messages[6]
    assert messages[14].startswith("np.asarray(...)") and "torch tensor" in messages[14]
    path = write(tmp_path, "parallel/bad.py", RELAUNCH_BAD)
    messages = {f.line: f.message for f in run_analysis(
        [path], context=CTX, rule_ids=["relaunch-loop-sync"]).findings}
    assert messages[4].startswith(".item()") and messages[7].startswith("int()")
    assert all("event" in m for m in messages.values())


def test_device_rule_suppression_is_honored(tmp_path):
    path = write(tmp_path, "ops/held.py", '''
        def warm(event):
            # distpow: ok hot-path-host-sync -- the warm-up wants to block
            event.synchronize()
    ''')
    report = run_analysis([path], context=CTX)
    assert report.findings == [] and len(report.suppressed) == 1


# -- the shipped tree and its context -----------------------------------------

def test_port_tree_has_zero_unsuppressed_findings():
    _, report = tree_reports()
    assert report.findings == [], "\n".join(f.format() for f in report.findings)
    assert len(report.suppressed) >= 10
    assert all(s.justification for _, s in report.suppressed)
    # the torch device rules hold the port's own syncs to a justification
    assert {f.rule for f, _ in report.suppressed} >= {"hot-path-host-sync"}


def test_context_parsed_from_the_ports_declarations():
    assert CTX == build_context(PACKAGE_ROOT)
    assert os.path.basename(PACKAGE_ROOT) == "distpow_tpu_torch"
    assert len(CTX.action_names) == 16
    assert "CoordinatorWorkerResult" in CTX.action_names
    assert {"worker.warmup_failures", "mesh.collective_host_waits"} <= CTX.counters
    assert "mesh.collective_s" in CTX.histograms
    assert "faults.injected." in CTX.counter_prefixes
    assert "rpc.client.call_s." in CTX.histogram_prefixes
    assert "proc.rss_bytes" in CTX.gauges
    assert {"Backend", "CacheFile", "MineRetries", "TelemetryDir"} <= CTX.config_fields
    # the port declares no JAX compilation cache
    assert not any(c.startswith("compile_cache.") for c in CTX.counters)


# -- the CLI ---------------------------------------------------------------------

_BAD = os.path.join("tests", "lint_fixtures", "blocking_under_lock_bad.py")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "distpow_tpu_torch.cli.lint", *args],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=env)


def test_cli_clean_tree_exits_zero_and_loads_no_torch():
    code = ("import sys, runpy\n"
            "sys.argv = ['lint', '--json']\n"
            "try:\n"
            "    runpy.run_module('distpow_tpu_torch.cli.lint', run_name='__main__')\n"
            "except SystemExit as exc:\n"
            "    rc = exc.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'distpow_tpu'))\n"
            "print(rc, bad, file=sys.stderr)\n"
            "sys.exit(rc if not bad else 9)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    payload = json.loads(out.stdout)
    assert payload["ok"] is True and payload["findings"] == []
    assert payload["checked_files"] > 100
    assert len(payload["suppressed"]) >= 10
    assert all(s["justification"] for s in payload["suppressed"])
    assert all(s["path"].startswith("distpow_tpu_torch/") for s in payload["suppressed"])


@pytest.mark.parametrize("args,rc,needle", [
    ((_BAD,), 1, "no-blocking-under-lock"),
    (("--rule", "no-such-rule"), 2, ""),
    (("no/such/path",), 2, ""),
    ((_BAD, "--rewrite-baseline"), 2, ""),
    (("--list-rules",), 0, "dead-package"),
], ids=["findings", "unknown-rule", "missing-path", "rewrite-needs-baseline", "list-rules"])
def test_cli_exit_codes(args, rc, needle):
    out = _cli(*args)
    assert out.returncode == rc, out.stdout + out.stderr
    assert needle in out.stdout


def test_cli_list_rules_in_the_references_order():
    out = _cli("--list-rules")
    ids = [line.split()[0] for line in out.stdout.splitlines() if line.strip()]
    assert ids == [r.RULE_ID for r in REF_RULES]


def _live_entries():
    payload = json.loads(_cli(_BAD, "--json").stdout)
    assert payload["findings"], "fixture must still produce findings"
    return [{"rule": f["rule"], "path": f["path"], "message": f["message"]}
            for f in payload["findings"]]


GONE = {"rule": "silent-except", "path": "distpow_tpu_torch/gone.py", "message": "fixed long ago"}


def test_stale_baseline_entry_is_a_finding(tmp_path):
    live = _live_entries()
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"findings": live + [GONE]}))
    out = _cli(_BAD, "--baseline", str(base))
    assert out.returncode == 1
    assert "stale-baseline" in out.stdout and "gone.py" in out.stdout
    assert "no-blocking-under-lock" not in out.stdout
    base.write_text(json.dumps({"findings": live}))
    out = _cli(_BAD, "--baseline", str(base))
    assert out.returncode == 0, out.stdout + out.stderr


def test_rewrite_baseline_prunes_only_stale_entries(tmp_path):
    live = _live_entries()
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"_comment": "kept", "findings": live + [GONE]}))
    out = _cli(_BAD, "--baseline", str(base), "--rewrite-baseline")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "pruned 1 stale" in out.stderr
    data = json.loads(base.read_text())
    assert data["_comment"] == "kept" and data["findings"] == live
    out2 = _cli(_BAD, "--baseline", str(base), "--rewrite-baseline")
    assert out2.returncode == 0 and "pruned" not in out2.stderr
    bad = tmp_path / "unreadable.json"
    bad.write_text("{")
    assert _cli(_BAD, "--baseline", str(bad)).returncode == 2
