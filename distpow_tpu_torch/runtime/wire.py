"""Binary wire codec v2 for the RPC data plane (docs/RPC.md).

Wire format v1 (runtime/rpc.py) is a 4-byte length prefix
plus UTF-8 JSON, and every byte field — nonce, secret, tracing token —
travels as an array of ints (the natural JSON form of the reference's
``[]uint8``).  That wire spends most of a Mine/Found frame on syntax:
repeated key strings, digits-and-commas byte arrays, base64 padding.
This module is the v2 payload encoding the RPC layer negotiates per
connection at dial time (``rpc.hello``): a struct-packed frame header,
interned method/key ids for the protocol's fixed vocabulary, and raw
``bytes`` for the byte fields.  The length-prefix framing, the fault
plane's frame mutations (runtime/faults.py truncate/duplicate/drop
operate on the encoded frame, not its syntax), and the
``rpc.frame.{sent,recv}_bytes`` histograms are codec-agnostic and
unchanged.

Frame payloads (everything after the 4-byte length prefix)::

    request  := 0x01 | varint id | method | value(params)
    response := 0x02 | varint id | u8 flags | [f64 retry_after]
                | [value ring] | value
    flags    := bit0 error (value is the error string)
                bit1 retry_after present (sched/admission.py typed
                     backpressure — the hint is a dedicated header
                     field, exactly like the JSON frame's dedicated
                     ``retry_after`` key)
                bit2 ring present (the cluster plane's NOT_OWNER
                     redirect ships a ring snapshot dict —
                     docs/CLUSTER.md; only pooled coordinators ever
                     set it, so pre-cluster traffic is bit-identical)

    method   := 0x80|idx            interned (METHODS table)
              | 0x00 varint len utf8  anything else

    value    := 0x00                         None
              | 0x01 / 0x02                  False / True
              | 0x03 zigzag-varint           int
              | 0x04 f64 big-endian          float
              | 0x05 varint len utf8         str
              | 0x06 varint len raw          bytes
              | 0x07 varint n value*         list
              | 0x08 varint n (key value)*   dict
    key      := 0x80|idx (KEYS table) | 0x00 varint len utf8

Varints are unsigned LEB128; ints are zigzag-mapped first so small
negatives stay small.  The METHODS/KEYS tables are part of the wire
contract: **append-only** — reordering or removing an entry changes the
meaning of frames already in flight from an older peer.  Golden-vector
tests (tests/test_wire.py) pin the exact bytes of representative frames
in both directions so an accidental table edit fails loudly.

Decoding is defensive: every read is bounds-checked, nesting depth and
varint width are capped, and any violation raises ``ValueError`` — the
same class a corrupt JSON frame raises, so rpc.py's existing
drop-the-connection error handling covers both codecs.

The port's own copy of the reference's ``runtime/wire.py``
(``distpow_tpu/runtime/wire.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

#: negotiated protocol version carried in the ``rpc.hello`` exchange
WIRE_VERSION = 2

# -- interning tables (append-only; see module docstring) --------------------

METHODS: Tuple[str, ...] = (
    "CoordRPCHandler.Mine",
    "CoordRPCHandler.Result",
    "CoordRPCHandler.Stats",
    "WorkerRPCHandler.Mine",
    "WorkerRPCHandler.Found",
    "WorkerRPCHandler.Cancel",
    "WorkerRPCHandler.Ping",
    "WorkerRPCHandler.Stats",
    # appended for the fleet membership plane (distpow_tpu/fleet/,
    # docs/FLEET.md); table stays append-only
    "Fleet.Register",
    "Fleet.Heartbeat",
    "Fleet.Drain",
    "Fleet.Members",
    # appended for the request-forensics plane (runtime/spans.py,
    # docs/FORENSICS.md): the role-agnostic observability surface;
    # table stays append-only
    "Node.Stats",
    "Node.Spans",
    # appended for the coordinator scale-out plane (distpow_tpu/cluster/,
    # docs/CLUSTER.md): the ring snapshot on demand; table stays
    # append-only
    "Cluster.Ring",
    # appended for the cache replication plane
    # (distpow_tpu/cluster/replication.py, docs/CLUSTER.md
    # "Replication & HA"): write-behind/anti-entropy pushes and the
    # warm shard handoff; table stays append-only
    "Cluster.CacheSync",
    "Cluster.Handoff",
)
_METHOD_IDS = {m: i for i, m in enumerate(METHODS)}

KEYS: Tuple[str, ...] = (
    "nonce",
    "num_trailing_zeros",
    "worker_byte",
    "worker_bits",
    "round",
    "token",
    "secret",
    "codec",
    "worker_tasks",
    # appended for the fleet membership plane (weighted shard ranges on
    # every Mine of a weighted round; lease plumbing on the low-rate
    # Fleet RPCs); table stays append-only
    "tb_lo",
    "tb_count",
    "lease_id",
    "worker_id",
    "capability",
    "ttl_s",
    "heartbeat_s",
    # appended for the request-forensics plane (Node.Spans request and
    # reply vocabulary — runtime/spans.py); table stays append-only
    "trace_id",
    "spans",
    "limit",
    "name",
    "node",
    "ts",
    "dur_s",
    "attrs",
    "seq",
    # appended for the coordinator scale-out plane (distpow_tpu/cluster/,
    # docs/CLUSTER.md): ring snapshots (Cluster.Ring / NOT_OWNER
    # redirects / the extended rpc.hello ack), the Mine reply-to addr a
    # pooled coordinator stamps so shared workers route each Result
    # back to its round's owner, and the no-redirect marker on hedged/
    # failover sends; table stays append-only
    "ring",
    "version",
    "vnodes",
    "members",
    "coord_addr",
    "no_redirect",
    "self",
    # appended for the cache replication plane
    # (distpow_tpu/cluster/replication.py): CacheSync/Handoff entry
    # batches, the anti-entropy digest exchange, and the install
    # accounting replies; table stays append-only
    "entries",
    "digest",
    "installed",
    "stale",
)
_KEY_IDS = {k: i for i, k in enumerate(KEYS)}

FRAME_REQUEST = 0x01
FRAME_RESPONSE = 0x02
FLAG_ERROR = 0x01
FLAG_RETRY_AFTER = 0x02
#: error frame carries a ring snapshot (the cluster plane's NOT_OWNER
#: redirect — docs/CLUSTER.md).  Only a POOLED coordinator ever sets
#: it, so single-coordinator deployments stay byte-identical to every
#: earlier version of this codec; a pre-cluster peer never receives the
#: flag because it never dials a pool.
FLAG_RING = 0x04

_TAG_NONE = 0x00
_TAG_FALSE = 0x01
_TAG_TRUE = 0x02
_TAG_INT = 0x03
_TAG_FLOAT = 0x04
_TAG_STR = 0x05
_TAG_BYTES = 0x06
_TAG_LIST = 0x07
_TAG_DICT = 0x08

_MAX_DEPTH = 32
_MAX_VARINT_BYTES = 10  # 70 bits — covers every counter this repo mints


# -- varints -----------------------------------------------------------------

def _put_varint(out: List[bytes], n: int) -> None:
    if n < 0:
        raise ValueError(f"varint must be non-negative, got {n}")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(bytes((b | 0x80,)))
        else:
            out.append(bytes((b,)))
            return


def _zigzag(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n) << 1) - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class _Cursor:
    """Bounds-checked reader over one frame's payload."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("truncated binary frame")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        shift = n = 0
        for i in range(_MAX_VARINT_BYTES):
            b = self.u8()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
        raise ValueError("varint wider than the protocol allows")

    def done(self) -> bool:
        return self.pos == len(self.data)


# -- value tree --------------------------------------------------------------

def _encode_value(out: List[bytes], v: Any, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("value nesting exceeds the wire depth cap")
    if v is None:
        out.append(bytes((_TAG_NONE,)))
    elif v is True:
        out.append(bytes((_TAG_TRUE,)))
    elif v is False:
        out.append(bytes((_TAG_FALSE,)))
    elif isinstance(v, int):
        out.append(bytes((_TAG_INT,)))
        _put_varint(out, _zigzag(v))
    elif isinstance(v, float):
        out.append(bytes((_TAG_FLOAT,)))
        out.append(struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode()
        out.append(bytes((_TAG_STR,)))
        _put_varint(out, len(raw))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        out.append(bytes((_TAG_BYTES,)))
        _put_varint(out, len(raw))
        out.append(raw)
    elif isinstance(v, (list, tuple)):
        out.append(bytes((_TAG_LIST,)))
        _put_varint(out, len(v))
        for item in v:
            _encode_value(out, item, depth + 1)
    elif isinstance(v, dict):
        out.append(bytes((_TAG_DICT,)))
        _put_varint(out, len(v))
        for k, item in v.items():
            if not isinstance(k, str):
                raise ValueError(f"wire dict keys must be str, got {type(k).__name__}")
            idx = _KEY_IDS.get(k)
            if idx is not None:
                out.append(bytes((0x80 | idx,)))
            else:
                raw = k.encode()
                out.append(b"\x00")
                _put_varint(out, len(raw))
                out.append(raw)
            _encode_value(out, item, depth + 1)
    else:
        raise ValueError(f"type {type(v).__name__} is not wire-encodable")


def _decode_value(cur: _Cursor, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise ValueError("value nesting exceeds the wire depth cap")
    tag = cur.u8()
    if tag == _TAG_NONE:
        return None
    if tag == _TAG_FALSE:
        return False
    if tag == _TAG_TRUE:
        return True
    if tag == _TAG_INT:
        return _unzigzag(cur.varint())
    if tag == _TAG_FLOAT:
        return struct.unpack(">d", cur.take(8))[0]
    if tag == _TAG_STR:
        return cur.take(cur.varint()).decode()
    if tag == _TAG_BYTES:
        return cur.take(cur.varint())
    if tag == _TAG_LIST:
        return [_decode_value(cur, depth + 1) for _ in range(cur.varint())]
    if tag == _TAG_DICT:
        out = {}
        for _ in range(cur.varint()):
            kb = cur.u8()
            if kb & 0x80:
                idx = kb & 0x7F
                if idx >= len(KEYS):
                    raise ValueError(f"unknown interned key id {idx}")
                k = KEYS[idx]
            elif kb == 0x00:
                k = cur.take(cur.varint()).decode()
            else:
                raise ValueError(f"malformed dict key marker 0x{kb:02x}")
            out[k] = _decode_value(cur, depth + 1)
        return out
    raise ValueError(f"unknown value tag 0x{tag:02x}")


# -- frames ------------------------------------------------------------------

def encode_frame(obj: dict) -> bytes:
    """Encode one request/response dict (the shape rpc.py passes around)
    into a v2 payload.  Requests are recognized by a ``method`` key."""
    out: List[bytes] = []
    rid = int(obj.get("id") or 0)
    if "method" in obj:
        out.append(bytes((FRAME_REQUEST,)))
        _put_varint(out, rid)
        method = obj["method"]
        idx = _METHOD_IDS.get(method)
        if idx is not None:
            out.append(bytes((0x80 | idx,)))
        else:
            raw = method.encode()
            out.append(b"\x00")
            _put_varint(out, len(raw))
            out.append(raw)
        _encode_value(out, obj.get("params") or {})
    else:
        out.append(bytes((FRAME_RESPONSE,)))
        _put_varint(out, rid)
        error = obj.get("error")
        retry_after = obj.get("retry_after")
        ring = obj.get("ring")
        flags = (FLAG_ERROR if error else 0) | \
            (FLAG_RETRY_AFTER if retry_after is not None else 0) | \
            (FLAG_RING if ring is not None else 0)
        out.append(bytes((flags,)))
        if retry_after is not None:
            out.append(struct.pack(">d", float(retry_after)))
        if ring is not None:
            _encode_value(out, ring)
        _encode_value(out, str(error) if error else obj.get("result"))
    return b"".join(out)


def decode_frame(data: bytes) -> dict:
    """Decode one v2 payload back into the dict shape rpc.py expects:
    ``{"id", "method", "params"}`` or ``{"id", "result", "error"[,
    "retry_after"]}``.  Raises ``ValueError`` on any malformation."""
    cur = _Cursor(bytes(data))
    kind = cur.u8()
    rid = cur.varint()
    if kind == FRAME_REQUEST:
        mb = cur.u8()
        if mb & 0x80:
            idx = mb & 0x7F
            if idx >= len(METHODS):
                raise ValueError(f"unknown interned method id {idx}")
            method = METHODS[idx]
        elif mb == 0x00:
            method = cur.take(cur.varint()).decode()
        else:
            raise ValueError(f"malformed method marker 0x{mb:02x}")
        params = _decode_value(cur)
        if not isinstance(params, dict):
            raise ValueError("request params must decode to a dict")
        obj = {"id": rid, "method": method, "params": params}
    elif kind == FRAME_RESPONSE:
        flags = cur.u8()
        if flags & ~(FLAG_ERROR | FLAG_RETRY_AFTER | FLAG_RING):
            raise ValueError(f"unknown response flags 0x{flags:02x}")
        retry_after = None
        if flags & FLAG_RETRY_AFTER:
            retry_after = struct.unpack(">d", cur.take(8))[0]
        ring = None
        if flags & FLAG_RING:
            ring = _decode_value(cur)
            if not isinstance(ring, dict):
                raise ValueError("ring frame field must decode to a dict")
        body = _decode_value(cur)
        if flags & FLAG_ERROR:
            if not isinstance(body, str):
                raise ValueError("error frame body must be a string")
            obj = {"id": rid, "result": None, "error": body}
        else:
            obj = {"id": rid, "result": body, "error": None}
        if retry_after is not None:
            obj["retry_after"] = retry_after
        if ring is not None:
            obj["ring"] = ring
    else:
        raise ValueError(f"unknown frame kind 0x{kind:02x}")
    if not cur.done():
        raise ValueError(
            f"{len(cur.data) - cur.pos} trailing byte(s) after frame body"
        )
    return obj
