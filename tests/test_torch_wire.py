"""The port's binary wire codec (``distpow_tpu_torch.runtime.wire``) is
byte-identical to the reference's: on the reference's golden frames and on
seeded random payloads, both encode the same bytes and each decodes the
other's frames; both refuse the same malformed frames."""

import numpy as np
import pytest

from distpow_tpu.runtime import wire as ref_wire
from distpow_tpu_torch.runtime import wire

SEED = 20261017
GOLDEN_FRAMES = [
    {"id": 1, "method": "WorkerRPCHandler.Mine",
     "params": {"nonce": b"\x01\x02\x03\x04", "num_trailing_zeros": 2, "worker_byte": 0,
                "worker_bits": 2, "round": "0000000018f2a3b4c5d6e7f0",
                "token": b"\x10\x11\x12\x13"}},
    {"id": 2, "result": {"worker_tasks": 1}, "error": None},
    {"id": 3, "result": None, "error": "RuntimeError: boom"},
    {"id": 4, "result": None, "error": "retry-after:0.500s coordinator run queue full (2/2)",
     "retry_after": 0.5},
    {"id": 5, "method": "rpc.custom",
     "params": {"x": -3, "f": 1.5, "b": True, "n": None, "l": [1, "s", b"\x00"]}},
]
# the protocol's methods and keys, so that the interned forms are drawn too
METHODS = list(ref_wire.METHODS) + ["rpc.custom", "S.Ping"]
KEYS = list(ref_wire.KEYS) + ["x", "payload", "z.dotted.key"]


def _value(rng, depth=0):
    kind = int(rng.integers(0, 9 if depth < 3 else 7))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-2**62, 2**62)) >> int(rng.integers(0, 62))
    if kind == 3:
        return float(rng.normal()) * 10.0 ** int(rng.integers(-9, 9))
    if kind == 4:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, size=int(rng.integers(0, 12))))
    if kind in (5, 6):
        return rng.integers(0, 256, size=int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
    if kind == 7:
        return [_value(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]
    return {KEYS[int(rng.integers(0, len(KEYS)))]: _value(rng, depth + 1)
            for _ in range(int(rng.integers(0, 6)))}


def _frame(rng, i):
    if i % 3 == 0:
        keys = rng.choice(KEYS, size=int(rng.integers(0, 7)), replace=False).tolist()
        return {"id": i, "method": METHODS[int(rng.integers(0, len(METHODS)))],
                "params": {k: _value(rng, 1) for k in keys}}
    if i % 3 == 1:
        return {"id": i, "result": _value(rng), "error": None}
    out = {"id": i, "result": None, "error": f"RuntimeError: failure {i}"}
    if i % 2:
        out["retry_after"] = float(rng.uniform(0, 5))
    return out


FRAMES = GOLDEN_FRAMES + [_frame(np.random.default_rng(SEED + i), i) for i in range(200)]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_same_bytes_and_cross_decoding(i):
    obj = FRAMES[i]
    ours, theirs = wire.encode_frame(obj), ref_wire.encode_frame(obj)
    assert ours == theirs
    assert wire.decode_frame(theirs) == ref_wire.decode_frame(ours) == \
        ref_wire.decode_frame(theirs)


def test_interning_tables_and_constants_are_the_references():
    assert wire.WIRE_VERSION == ref_wire.WIRE_VERSION
    assert list(wire.METHODS) == list(ref_wire.METHODS)
    assert list(wire.KEYS) == list(ref_wire.KEYS)
    assert (wire.FRAME_REQUEST, wire.FRAME_RESPONSE, wire.FLAG_ERROR,
            wire.FLAG_RETRY_AFTER, wire.FLAG_RING) == (
        ref_wire.FRAME_REQUEST, ref_wire.FRAME_RESPONSE, ref_wire.FLAG_ERROR,
        ref_wire.FLAG_RETRY_AFTER, ref_wire.FLAG_RING)


def test_both_refuse_the_same_malformed_frames():
    good = wire.encode_frame(GOLDEN_FRAMES[0])
    for bad in (b"", b"\x09", good[:-1], good + b"\x00", b"\x01\x01\xff", b"\x02\x01\x80",
                b"\x01\x01\x80"):
        with pytest.raises(ValueError):
            wire.decode_frame(bad)
        with pytest.raises(ValueError):
            ref_wire.decode_frame(bad)
