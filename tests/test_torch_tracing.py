"""The port's tracer (``distpow_tpu_torch.runtime.tracing``) against the
reference's: the same trace-id sequence per identity (``crc32(identity) <<
32 | counter``), the same events and vector clocks over a seeded exchange
of tokens between a port node and a reference node, tokens that round-trip
in every wire form (raw bytes, the JSON codec's int list, the legacy
base64 string) from either package to the other, and the same actions'
fields."""

import zlib

import numpy as np
import pytest

from distpow_tpu.runtime import actions as ref_actions
from distpow_tpu.runtime import tracing as ref_tracing
from distpow_tpu_torch.runtime import actions, tracing

SEED = 20261017
IDENTITIES = ["client1", "client2", "coordinator", "worker1", "worker4", "äöü-node"]


@pytest.mark.parametrize("identity", IDENTITIES)
def test_trace_id_sequence_matches_reference(identity):
    a = tracing.Tracer(identity, tracing.MemorySink())
    b = ref_tracing.Tracer(identity, ref_tracing.MemorySink())
    ids = [a.create_trace().trace_id for _ in range(20)]
    assert ids == [b.create_trace().trace_id for _ in range(20)]
    tag = zlib.crc32(identity.encode()) & 0xFFFFFFFF
    assert ids == [tag << 32 | i for i in range(1, 21)]


def _forms(pkg, token):
    """Every wire form a peer may send a token in."""
    return [pkg.wire_token(token), list(token), pkg.encode_token(token), bytes(token)]


@pytest.mark.parametrize("first", ["port", "ref"])
def test_seeded_exchange_gives_the_reference_events(first):
    """Two nodes pass one request's token back and forth, each recording a
    seeded mix of actions; the same exchange between two reference nodes
    gives the same events (types, trace ids, bodies, vector clocks)."""
    def run(mixed):
        pkgs = {"port": (tracing, actions), "ref": (ref_tracing, ref_actions)}
        order = [first, "ref" if first == "port" else "port"] if mixed else ["ref", "ref"]
        nodes = [pkgs[p][0].Tracer(f"node{i}", pkgs[p][0].MemorySink())
                 for i, p in enumerate(order)]
        acts = [pkgs[p][1] for p in order]
        rng = np.random.default_rng(SEED)
        trace = nodes[0].create_trace()
        cur = 0
        for step in range(24):
            nonce = rng.integers(0, 256, size=4, dtype=np.uint8).tobytes()
            kind = int(rng.integers(0, 4))
            a = acts[cur]
            action = [a.WorkerMine(nonce=nonce, num_trailing_zeros=step, worker_byte=kind),
                      a.CacheMiss(nonce=nonce, num_trailing_zeros=step),
                      a.WorkerResult(nonce=nonce, num_trailing_zeros=step, worker_byte=kind,
                                     secret=nonce[:2]),
                      a.CacheAdd(nonce=nonce, num_trailing_zeros=step, secret=nonce)][kind]
            trace.record_action(action)
            if rng.integers(0, 2):
                token = trace.generate_token()
                cur = 1 - cur
                pkg = tracing if order[cur] == "port" else ref_tracing
                form = _forms(pkg, token)[int(rng.integers(0, 4))]
                trace = nodes[cur].receive_token(pkg.decode_token(form))
        return [n.sink.events for n in nodes]

    assert run(mixed=True) == run(mixed=False)


@pytest.mark.parametrize("sender,receiver", [("port", "ref"), ("ref", "port")])
def test_tokens_round_trip_both_ways(sender, receiver):
    pkgs = {"port": tracing, "ref": ref_tracing}
    src = pkgs[sender].Tracer("worker1", pkgs[sender].MemorySink())
    dst = pkgs[receiver].Tracer("coordinator", pkgs[receiver].MemorySink())
    for _ in range(3):
        trace = src.create_trace()
        token = trace.generate_token()
        for form in _forms(pkgs[sender], token):
            assert pkgs[receiver].decode_token(form) == token
            assert dst.receive_token(pkgs[receiver].decode_token(form)).trace_id == \
                trace.trace_id
        back = dst.receive_token(token).generate_token()
        assert src.receive_token(pkgs[sender].decode_token(list(back))).trace_id == \
            trace.trace_id
    assert pkgs[receiver].decode_token(None) is None


def test_action_vocabulary_and_fields_match():
    assert sorted(actions.ACTION_TYPES) == sorted(ref_actions.ACTION_TYPES)
    for name, cls in actions.ACTION_TYPES.items():
        ref_cls = ref_actions.ACTION_TYPES[name]
        kwargs = {f: (b"\x01\x02" if f in ("nonce", "secret") else 3)
                  for f in cls.__dataclass_fields__}
        assert cls(**kwargs).to_fields() == ref_cls(**kwargs).to_fields()
        assert cls(**kwargs).name == ref_cls(**kwargs).name
