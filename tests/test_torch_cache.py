"""The port's dominance cache (``distpow_tpu_torch.runtime.cache``) against
the reference's ``ResultCache``: over a seeded sequence of puts, gets and
unmetered ``satisfies`` lookups both caches make the same decisions (the
returned secrets, the recorded cache actions, the converged entries), and
each package loads the JSONL journal the other wrote, a torn tail
included."""

import numpy as np
import pytest

from distpow_tpu.runtime import cache as ref_cache
from distpow_tpu.runtime import tracing as ref_tracing
from distpow_tpu_torch.runtime import cache, tracing

SEED = 20261017


def _ops(seed, n=400):
    """(op, nonce, ntz, secret): a few nonces, so that puts dominate,
    tie and lose against each other."""
    rng = np.random.default_rng(seed)
    nonces = [rng.integers(0, 256, size=int(rng.integers(1, 6)), dtype=np.uint8).tobytes()
              for _ in range(6)]
    out = []
    for _ in range(n):
        op = ("add", "get", "satisfies")[int(rng.integers(0, 3))]
        secret = rng.integers(0, 256, size=int(rng.integers(0, 5)), dtype=np.uint8).tobytes()
        out.append((op, nonces[int(rng.integers(0, len(nonces)))], int(rng.integers(0, 9)),
                    secret))
    return out


def _drive(pkg, trc_pkg, ops, path=None):
    c = pkg.ResultCache(persist_path=path)
    sink = trc_pkg.MemorySink()
    trace = trc_pkg.Tracer("coordinator", sink).create_trace()
    results = []
    for op, nonce, ntz, secret in ops:
        if op == "add":
            results.append(c.add(nonce, ntz, secret, trace))
        elif op == "get":
            results.append(c.get(nonce, ntz, trace))
        else:
            results.append(c.satisfies(nonce, ntz))
    entries = sorted(c.entries_snapshot())
    c.close()
    return results, [(e["action"], e["body"]) for e in sink.events if e["type"] == "action"], \
        entries, len(c)


@pytest.mark.parametrize("seed", [SEED + i for i in range(6)])
def test_dominance_decisions_match_reference(seed):
    ops = _ops(seed)
    ours = _drive(cache, tracing, ops)
    assert ours == _drive(ref_cache, ref_tracing, ops)
    results, recorded, entries, _ = ours
    assert entries and {a for a, _ in recorded} >= {"CacheAdd", "CacheHit", "CacheMiss",
                                                    "CacheRemove"}
    assert any(r is None for r in results) and any(r is not None for r in results)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("torn", [False, True])
def test_journal_written_by_one_loads_in_the_other(tmp_path, writer, reader, torn):
    pkgs = {"port": (cache, tracing), "ref": (ref_cache, ref_tracing)}
    ops = [op for op in _ops(SEED + 99) if op[0] == "add"]
    path = str(tmp_path / "cache.jsonl")
    _drive(*pkgs[writer], ops, path=path)
    if torn:
        with open(path, "a") as fh:
            fh.write('{"nonce": "0a0b", "ntz": ')  # a crash mid-append
    loaded = pkgs[reader][0].ResultCache(persist_path=path)
    want = pkgs[writer][0].ResultCache(persist_path=None)
    for _, nonce, ntz, secret in ops:
        want.add(nonce, ntz, secret, None)
    try:
        got = sorted(loaded.entries_snapshot())
        assert got == sorted(want.entries_snapshot()) and got
        # the torn tail was compacted away: the journal replays cleanly in the writer
        loaded.close()
        again = pkgs[writer][0].ResultCache(persist_path=path)
        assert sorted(again.entries_snapshot()) == got
        again.close()
    finally:
        loaded.close()
        want.close()
