"""Trace-log validator — the protocol's ordering oracle.

The reference system's de-facto acceptance test is its distributed trace
(SURVEY.md section 4): every protocol step records a typed action into a
causally-ordered log, and grading inspects the ordering invariants.  This
module makes that inspection executable: it parses the tracing server's
human log (``trace_output.log``) and ShiViz log and reports violations of
the invariants the reference protocol guarantees:

Per trace, per node (file order within one node's events is that node's
program order — each tracer ships events over one FIFO connection):

* client   — ``PowlibMiningBegin`` -> ``PowlibMine`` -> ... ->
  ``PowlibSuccess`` -> ``PowlibMiningComplete`` (powlib.go:106-176).
* coordinator — starts with ``CoordinatorMine``; then either
  ``CacheHit`` -> ``CoordinatorSuccess`` (the hit fast path,
  coordinator.go:150-166) or ``CacheMiss`` -> one
  ``CoordinatorWorkerMine`` per shard -> ... -> ``CoordinatorSuccess``
  last (coordinator.go:139-298); every ``CacheRemove`` is immediately
  followed by a ``CacheAdd`` for the same nonce (coordinator.go:436-454).
* worker   — per (identity, worker_byte): ``WorkerMine`` first; at most
  one ``WorkerResult``; ``WorkerCancel`` present and strictly after any
  ``WorkerResult`` — the finding worker blocks on its cancel channel so
  ``WorkerCancel`` is always its last action for the task
  (worker.go:357-396).

ShiViz log: per-host vector-clock components must increment by exactly 1
on each of that host's events, and no component may ever decrease —
violations mean the happens-before graph is corrupt.

Coordinator-pool traces (docs/CLUSTER.md): when a trace shows MULTIPLE
coordinator identities (client failover after a shard death re-issues
the same trace's mine at a sibling), the per-coordinator Success
requirement relaxes to at-least-one-member and per-shard WorkerResult
counts are bounded by the member count — the dead member's truncated
round fragment is evidence of the chaos, not a protocol bug.  Traces
with one coordinator identity keep the strict reference oracle
unchanged.

Usage: ``python -m distpow_tpu_torch.cli.trace_check trace_output.log
[shiviz_output.log]`` — exits non-zero and prints each violation.

The port's own copy of the reference's ``runtime/trace_check.py``
(``distpow_tpu/runtime/trace_check.py``):
it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

ACTION_RE = re.compile(
    r"^\[(?P<id>[^\]]+)\] TraceID=(?P<tid>\d+) (?P<action>[A-Za-z]\w*)"
    r"(?: (?P<body>.*))?$"
)
TOKEN_RE = re.compile(
    r"^\[(?P<id>[^\]]+)\] (?P<kind>generate_token|receive_token)"
    r" TraceID=(?P<tid>\d+)$"
)

CLIENT_ACTIONS = {
    "PowlibMiningBegin", "PowlibMine", "PowlibMineWithToken",
    "PowlibSuccess", "PowlibMiningComplete",
}
COORD_ACTIONS = {
    "CoordinatorMine", "CoordinatorWorkerMine", "CoordinatorWorkerResult",
    "CoordinatorWorkerCancel", "CoordinatorSuccess",
}
WORKER_ACTIONS = {"WorkerMine", "WorkerResult", "WorkerCancel"}
CACHE_ACTIONS = {"CacheAdd", "CacheRemove", "CacheHit", "CacheMiss"}


@dataclass
class Event:
    line_no: int
    identity: str
    trace_id: int
    action: str
    body: dict


def _parse_body(raw: Optional[str]) -> dict:
    """Parse ``k=v, k=v`` bodies; values are best-effort literals."""
    body: dict = {}
    if not raw:
        return body
    # values may contain ", " inside list literals; split on ", " only at
    # top nesting level
    parts, depth, cur = [], 0, ""
    for ch in raw:
        if ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    for part in parts:
        k, _, v = part.strip().partition("=")
        v = v.strip()
        try:
            body[k] = json.loads(v)
        except (ValueError, json.JSONDecodeError):
            body[k] = v
    return body


def parse_trace_log(path: str) -> List[Event]:
    events: List[Event] = []
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line or TOKEN_RE.match(line):
                continue
            m = ACTION_RE.match(line)
            if m is None:
                continue
            events.append(Event(
                line_no=i,
                identity=m.group("id"),
                trace_id=int(m.group("tid")),
                action=m.group("action"),
                body=_parse_body(m.group("body")),
            ))
    return events


def _check_client(trace_id: int, seq: List[Event], out: List[str]) -> None:
    names = [e.action for e in seq if e.action in CLIENT_ACTIONS]
    if not names:
        return
    if names[0] != "PowlibMiningBegin":
        out.append(f"trace {trace_id}: client sequence starts with "
                   f"{names[0]}, expected PowlibMiningBegin")
    want_after_begin = {"PowlibMine", "PowlibMineWithToken"}
    if len(names) > 1 and names[1] not in want_after_begin:
        out.append(f"trace {trace_id}: PowlibMiningBegin followed by "
                   f"{names[1]}, expected PowlibMine")
    if "PowlibMiningComplete" in names:
        if names[-1] != "PowlibMiningComplete":
            out.append(f"trace {trace_id}: PowlibMiningComplete is not the "
                       f"client's final action")
        if "PowlibSuccess" in names and (
            names.index("PowlibSuccess")
            > names.index("PowlibMiningComplete")
        ):
            out.append(f"trace {trace_id}: PowlibSuccess after "
                       f"PowlibMiningComplete")


def _check_coordinator(trace_id: int, seq: List[Event], out: List[str],
                       require_success: bool = True) -> None:
    names = [e.action for e in seq]
    coord = [n for n in names if n in COORD_ACTIONS or n in CACHE_ACTIONS]
    if not coord:
        return
    if coord[0] != "CoordinatorMine":
        out.append(f"trace {trace_id}: coordinator sequence starts with "
                   f"{coord[0]}, expected CoordinatorMine")
    if require_success and "CoordinatorSuccess" not in coord:
        out.append(f"trace {trace_id}: no CoordinatorSuccess")
    if "CacheHit" in coord and "CoordinatorWorkerMine" in coord:
        # a hit before any fan-out means the fan-out should not exist for
        # the SAME request; both can appear when the trace covers a
        # miss-then-dominated-repeat — only flag hit-THEN-mine order
        if coord.index("CacheHit") < coord.index("CoordinatorWorkerMine"):
            out.append(f"trace {trace_id}: fan-out after CacheHit")
    if "CoordinatorWorkerMine" in coord and "CacheMiss" in coord:
        if coord.index("CacheMiss") > coord.index("CoordinatorWorkerMine"):
            out.append(f"trace {trace_id}: fan-out before CacheMiss")
    # CacheRemove must be immediately followed by CacheAdd (same node)
    for i, e in enumerate(seq):
        if e.action == "CacheRemove":
            nxt = seq[i + 1] if i + 1 < len(seq) else None
            if nxt is None or nxt.action != "CacheAdd":
                out.append(
                    f"trace {trace_id}: CacheRemove (line {e.line_no}) not "
                    f"immediately followed by CacheAdd"
                )


def _check_worker(trace_id: int, identity: str, seq: List[Event],
                  out: List[str], max_results: int = 1) -> None:
    per_byte: Dict[object, List[Event]] = {}
    for e in seq:
        if e.action in WORKER_ACTIONS:
            per_byte.setdefault(e.body.get("WorkerByte"), []).append(e)
    for byte, evs in per_byte.items():
        names = [e.action for e in evs]
        if names and names[0] != "WorkerMine" and "WorkerMine" in names:
            out.append(f"trace {trace_id}: {identity} shard {byte}: "
                       f"{names[0]} before WorkerMine")
        if names.count("WorkerResult") > max_results:
            out.append(f"trace {trace_id}: {identity} shard {byte}: "
                       f"multiple WorkerResult")
        if "WorkerResult" in names:
            if "WorkerCancel" not in names:
                out.append(f"trace {trace_id}: {identity} shard {byte}: "
                           f"WorkerResult without a following WorkerCancel")
            elif names.index("WorkerCancel") < names.index("WorkerResult"):
                out.append(f"trace {trace_id}: {identity} shard {byte}: "
                           f"WorkerCancel before WorkerResult")
        if "WorkerCancel" in names and names[-1] != "WorkerCancel":
            out.append(f"trace {trace_id}: {identity} shard {byte}: "
                       f"WorkerCancel is not the final worker action")


def check_trace_log(path: str) -> List[str]:
    """Validate ordering invariants; returns a list of violations."""
    events = parse_trace_log(path)
    out: List[str] = []
    by_trace: Dict[int, List[Event]] = {}
    for e in events:
        by_trace.setdefault(e.trace_id, []).append(e)
    for trace_id, evs in sorted(by_trace.items()):
        by_node: Dict[str, List[Event]] = {}
        for e in evs:
            by_node.setdefault(e.identity, []).append(e)
        # coordinator-POOL traces (docs/CLUSTER.md): a client failover
        # can legitimately leave one round per pool member in ONE trace
        # — the member that died mid-round contributes a truncated
        # fragment (CoordinatorMine, fan-out, no Success) and each
        # fan-out may earn a shard one more WorkerResult.  The relaxed
        # invariants — Success on at least ONE member, per-shard
        # results bounded by the member count — apply ONLY when the
        # trace shows multiple coordinator identities; single-
        # coordinator traces keep the strict reference oracle.
        coord_ids = [i for i, seq in by_node.items()
                     if {e.action for e in seq} & COORD_ACTIONS]
        pool = len(coord_ids) > 1
        if pool and not any(
            "CoordinatorSuccess" in [e.action for e in by_node[i]]
            for i in coord_ids
        ):
            out.append(f"trace {trace_id}: no CoordinatorSuccess on any "
                       f"of the {len(coord_ids)} pool members")
        for identity, seq in by_node.items():
            kinds = {e.action for e in seq}
            if kinds & CLIENT_ACTIONS:
                _check_client(trace_id, seq, out)
            if kinds & COORD_ACTIONS:
                _check_coordinator(trace_id, seq, out,
                                   require_success=not pool)
            if kinds & WORKER_ACTIONS:
                _check_worker(trace_id, identity, seq, out,
                              max_results=max(1, len(coord_ids)))
    return out


def check_shiviz_log(path: str) -> List[str]:
    """Validate the vector-clock log: per-host components increment by 1
    on own events and never decrease anywhere."""
    out: List[str] = []
    last_seen: Dict[str, Dict[str, int]] = {}
    own: Dict[str, int] = {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    # skip the parser-regex header (first non-empty lines up to a blank)
    while i < len(lines) and lines[i].strip():
        i += 1
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip():
            continue
        host, _, vc_raw = line.partition(" ")
        if not vc_raw.startswith("{"):
            continue
        try:
            vc = {k: int(v) for k, v in json.loads(vc_raw).items()}
        except (ValueError, json.JSONDecodeError):
            out.append(f"line {i}: unparsable vector clock")
            continue
        i += 1  # the description line
        mine = vc.get(host, 0)
        prev_own = own.get(host, 0)
        if mine == 1 and prev_own > 1:
            # identity restart: a fresh process reusing the name starts a
            # new epoch (the server appends across runs) — reset baseline
            last_seen.pop(host, None)
        elif mine != prev_own + 1:
            out.append(
                f"line {i - 1}: {host} clock component jumped "
                f"{prev_own} -> {mine} (expected +1)"
            )
        own[host] = mine
        prev = last_seen.get(host, {})
        for h, v in prev.items():
            if vc.get(h, 0) < v and h != host:
                out.append(
                    f"line {i - 1}: {host} clock component for {h} "
                    f"decreased {v} -> {vc.get(h, 0)}"
                )
        last_seen[host] = {**prev, **vc}
    return out
