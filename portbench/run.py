"""The benchmark of ``distpow_tpu_torch``: one run of one cell.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

A run boots the cell's deployment (``stack.py``: the port's coordinator
and workers, each its own process), connects as the client through the
port's client library (``nodes/powlib.py`` ``POW.mine``), warms the
deployment with the mix's warm-up puzzles, then sends the mix's puzzles
for ``S`` seconds.  After the window it waits for every puzzle sent in it,
reads the nodes' counters, stops every process, and judges each answer
with the plain reference (``check.py``).  The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.

``--trace 0`` reports the cell's end-to-end metrics, all from the client's
clock: ``solve_rate`` (verified solves completed in the window per
second), ``solve_p50_ms`` and ``solve_p95_ms`` (over every puzzle sent in
the window, from its ``Mine`` call to its ``Result``), and ``setup_s``
(process start to the window's first request).  ``--trace 1`` runs
``torch.profiler`` in each worker over the window and reports the cell's
per-layer metrics (``metrics/<name>.py``).
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import deque  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import check, reference, spec  # noqa: E402
from .launcher import loaded_forbidden  # noqa: E402
from .stack import Stack  # noqa: E402
from .window import Window, exact_percentile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP_TIMEOUT_S = 1100.0
CLOSE_WAIT_S = 60.0
SPAN_SAMPLE = 128


@dataclass
class Sent:
    nonce: bytes
    ntz: int
    t0: float  # the Mine call
    in_window: bool
    t1: Optional[float] = None
    secret: Optional[bytes] = None
    error: Optional[str] = None
    trace_id: Optional[int] = None


class Client:
    """The port's client library on one connection.  A result is matched
    to the oldest unanswered puzzle of its nonce and difficulty."""

    def __init__(self, addr: str):
        from distpow_tpu_torch.nodes.powlib import POW
        from distpow_tpu_torch.runtime.tracing import make_tracer

        self.pow = POW()
        self.results = self.pow.initialize(addr, 256)
        self.tracer = make_tracer("portbench")
        self.sent: List[Sent] = []
        self._pending: Dict[tuple, deque] = {}

    def mine(self, req, t0: float, in_window: bool) -> None:
        s = Sent(req.nonce, req.ntz, t0, in_window)
        self.sent.append(s)
        self._pending.setdefault((req.nonce, req.ntz), deque()).append(s)
        self.pow.mine(self.tracer, req.nonce, req.ntz)

    def take(self, timeout: float) -> Optional[Sent]:
        try:
            r = self.results.get(timeout=max(0.0, timeout))
        except queue.Empty:
            return None
        t1 = time.monotonic()
        waiting = self._pending.get((bytes(r.nonce), r.num_trailing_zeros))
        if not waiting:
            raise RuntimeError(f"a result for no puzzle sent: {r}")
        s = waiting.popleft()
        s.t1, s.secret, s.error = t1, r.secret, r.error
        if r.token is not None:
            s.trace_id = json.loads(bytes(r.token))["trace_id"]
        return s

    def outstanding(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def close(self) -> None:
        self.pow.close()


def _drain(client: Client, deadline: float, stack: Stack) -> None:
    while client.outstanding() and time.monotonic() < deadline:
        stack.check_alive()
        client.take(min(1.0, deadline - time.monotonic()))


def _closed_loop(client: Client, reqs, clients: int, t_close: float, stack: Stack) -> None:
    for _ in range(clients):
        client.mine(next(reqs), time.monotonic(), True)
    while True:
        now = time.monotonic()
        if now >= t_close:
            return
        if client.take(min(1.0, t_close - now)) is not None:
            if time.monotonic() < t_close:
                client.mine(next(reqs), time.monotonic(), True)
        else:
            stack.check_alive()


def _card(cards: List[int]) -> dict:
    """The cards the run's workers use (``cards``, as CUDA numbers them),
    each as ``nvidia-smi`` names it with its power limit.  The harness does
    not import ``torch``, which would take the CPU from the workers' boot;
    each worker checks its card with ``torch`` itself and fails without
    one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    listed = [line.strip() for line in out.splitlines() if line.strip()]
    return {"cards": [listed[i] for i in sorted(set(cards)) if i < len(listed)]}


class NoCard(RuntimeError):
    pass


def _mark(phases: Dict[str, float], name: str, t_start: float) -> None:
    """Note a phase of the run, and say it on standard error, so that a
    run that stalls shows where."""
    phases[name] = time.monotonic() - t_start
    print(f"portbench: {name} at {phases[name]:.3f} s", file=sys.stderr, flush=True)


def _scrape(clients) -> List[dict]:
    return [c.call("Node.Stats", {}, timeout=30) for c in clients]


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: str = ROOT,
        device: str = "cuda", fault: Optional[str] = None, close_wait_s: float = CLOSE_WAIT_S,
        setup_timeout_s: float = SETUP_TIMEOUT_S, t_start: float = T0) -> dict:
    """One run of ``workload``; returns the result line's object (with
    ``checks``, the numbers compared and their limits, as its last key)."""
    from distpow_tpu_torch.runtime.rpc import RPCClient

    cell = spec.load(root, workload)
    config, mix = cell.config, cell.mix
    card = {}
    tmp = tempfile.mkdtemp(prefix="portbench-")
    build_dir = os.path.join(root, spec.PKG, ".cache", "build")
    stack = Stack(root, tmp, build_dir, config, cell.chips, device, fault)
    nodes: List = []
    client = None
    phases: Dict[str, float] = {}
    try:
        stack.boot()
        _mark(phases, "booted", t_start)
        if device == "cuda":  # while the workers boot
            card = _card(stack.cards)
            if len(card["cards"]) < cell.chips:
                raise NoCard(f"the cell needs {cell.chips} CUDA device(s); "
                             f"this machine shows {len(card['cards'])}")
        client = Client(stack.client_addr)
        warm = iter(mix.warmup())
        deadline = time.monotonic() + setup_timeout_s
        for _ in range(mix.clients):
            req = next(warm, None)
            if req is not None:
                client.mine(req, time.monotonic(), False)
        while client.outstanding():
            if time.monotonic() > deadline:
                raise RuntimeError("the warm-up did not finish in time")
            stack.check_alive()
            if client.take(1.0) is not None:
                if "first_warmup_answer" not in phases:
                    _mark(phases, "first_warmup_answer", t_start)
                req = next(warm, None)
                if req is not None:
                    client.mine(req, time.monotonic(), False)
        bad = [s for s in client.sent if s.error]
        if bad:
            raise RuntimeError(f"a warm-up puzzle failed: {bad[0].error}")
        nodes = [RPCClient(stack.client_addr)] + [RPCClient(a) for a in stack.worker_addrs]
        before = _scrape(nodes)
        if trace:
            stack.send("trace_start", stack.workers)
            _mark(phases, "trace_started", t_start)
        if fault:
            stack.send("arm", stack.workers)
        t_open = time.monotonic()
        setup_s = t_open - t_start
        _mark(phases, "window_open", t_start)
        t_close = t_open + seconds
        _closed_loop(client, mix.closed(seed), mix.clients, t_close, stack)
        window_s = time.monotonic() - t_open
        _mark(phases, "window_closed", t_start)
        after = _scrape(nodes)
        profiles = []
        if trace:
            paths = [os.path.join(tmp, f"profile{i}.json") for i in range(len(stack.workers))]
            stack.send("trace_stop", stack.workers, each=[{"path": p} for p in paths],
                       window_s=window_s)
            for p in paths:
                with open(p) as fh:
                    profiles.append(json.load(fh))
            _mark(phases, "trace_stopped", t_start)
        _drain(client, time.monotonic() + close_wait_s, stack)
        _mark(phases, "drained", t_start)
        final = _scrape(nodes)
        winners = _winners(nodes[0], client, seed)
        reports = stack.send("report", stack.nodes)
        _mark(phases, "reported", t_start)
    except NoCard:
        raise
    except BaseException:
        print(stack.logs_tail(), file=sys.stderr)
        raise
    finally:
        if client is not None:
            client.close()
        for n in nodes:
            n.close()
        stack.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    loaded = {i: r["forbidden"] for i, r in enumerate(reports) if r["forbidden"]}
    if loaded:
        raise RuntimeError(f"nodes (0 the coordinator) loaded JAX modules: {loaded}")
    reports = reports[1:]  # the workers'
    window = [s for s in client.sent if s.in_window]
    checks = check.judge(config, window, final[0], final[1:], winners)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    solved = [s for s in window if s.t1 is not None and s.t1 <= t_close and check.solves(config, s)]
    kind = reports[0]["kind"]
    result = {"correct": correct, "attempted": len(window),
              "failed": sum(1 for s in window if not check.solves(config, s)),
              "metrics": {}, "device": {
                  "platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                  "count": cell.chips,
                  "memory_peak_bytes": max(r["memory_peak_bytes"] for r in reports)}}
    if trace:
        with open(os.path.join(root, spec.PKG, "peaks.json")) as fh:
            peak = json.load(fh).get(kind)
        n = int(config["Workers"])
        win = Window(window_s, config,
                     [(s.ntz, s.t1 - s.t0, reference.candidates(s.secret, n)) for s in solved],
                     (before[0], after[0]), list(zip(before[1:], after[1:])), profiles, peak)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, read in cell.readers.items():
            value = read(win)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": units[name]}
        if profiles:
            result["device"]["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
            result["device"]["window_s"] = sum(p["window_s"] for p in profiles) / len(profiles)
            result["breakdown"] = _breakdown(profiles)
    else:
        lat = [(s.t1 - s.t0) * 1e3 for s in window if s.t1 is not None and s.error is None]
        values = {"solve_rate": len(solved) / window_s,
                  "solve_p50_ms": exact_percentile(lat, 0.50),
                  "solve_p95_ms": exact_percentile(lat, 0.95), "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    for i, r in enumerate(reports):  # each worker's boot, on the same clock
        for mark, at in r.get("boot", {}).items():
            phases[f"worker{i + 1}.{mark}"] = at - (time.time() - (time.monotonic() - t_start))
    result["card"] = card
    result["setup_phases_s"] = phases
    result["checks"] = checks
    return result


def _winners(coord, client: Client, seed: int) -> List[tuple]:
    """``(secret, winning worker)`` of a sample of the window's answered
    puzzles, drawn from the seed with the slowest among them, from the
    coordinator's ``coord.first_result`` spans."""
    done = [s for s in client.sent
            if s.in_window and s.secret is not None and s.trace_id is not None]
    if not done:
        return []
    done.sort(key=lambda s: s.nonce)
    slowest = max(done, key=lambda s: s.t1 - s.t0)
    sample = random.Random(f"sample:{seed}").sample(done, min(SPAN_SAMPLE, len(done)))
    if slowest not in sample:
        sample[-1] = slowest
    out = []
    for s in sample:
        spans = coord.call("Node.Spans", {"trace_id": s.trace_id}, timeout=30)["spans"]
        for sp in spans:
            if sp["name"] == "coord.first_result" and "winner_byte" in sp.get("attrs", {}):
                out.append((s.secret, int(sp["attrs"]["winner_byte"])))
    return out


def _breakdown(profiles: List[dict]) -> dict:
    ops: Dict[str, float] = {}
    for p in profiles:
        for name, s in p["device_ops"].items():
            ops[name] = ops.get(name, 0.0) + s
    gaps = sorted((g for p in profiles for g in p["idle_gaps"]), key=lambda g: -g[1])
    return {"device_ops": sorted(([n[:200], s] for n, s in ops.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[n[:200], s] for n, s in gaps[:10]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault in the workers (faults.py); control runs and tests only")
    args = ap.parse_args(argv)
    faulthandler.register(signal.SIGUSR1, all_threads=True)  # a stalled run's stacks
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), fault=args.fault)
    except NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    loaded = loaded_forbidden()
    if loaded:
        print(f"portbench: the run's process loaded {loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
