"""The port's pipelined driver against the JAX package's ``search`` and the
hashlib oracle, on the CPU.  The port runs through ``get_backend("torch",
device="cpu")`` (the plain step) and ``get_backend("cuda", device="cpu")``
(the kernel wrapper, which takes the plain path for CPU tensors).  Exact
equality: same secret, same ``hashes_tried``."""

import hashlib
import itertools

import pytest

from distpow_tpu.parallel.search import search as jax_search
from distpow_tpu_torch.backends import get_backend
from distpow_tpu_torch.models import puzzle
from distpow_tpu_torch.parallel.partition import thread_bytes, worker_bits
from distpow_tpu_torch.parallel.search import search
from distpow_tpu_torch.runtime.metrics import Metrics

BATCH = 1 << 12
LAUNCH = 1 << 14


def _port_search(backend_name, nonce, d, tbs, **kw):
    """The port's driver with the backend's own step factory, so the
    SearchResult (and its hashes_tried) is visible."""
    be = get_backend(backend_name, device="cpu", batch_size=BATCH, max_launch=LAUNCH)
    if backend_name == "cuda":
        from distpow_tpu_torch.parallel.partition import contiguous_bounds

        lo, tbc = contiguous_bounds(tbs)
        kw["step_factory"] = be._factory(bytes(nonce), d, lo, tbc)
    return search(nonce, d, tbs, batch_size=BATCH, launch_candidates=LAUNCH,
                  device="cpu", **kw)


# (nonce, difficulty, workers, worker index)
CASES = [
    (b"\x01\x02\x03\x04", 3, 1, 0),
    (b"\x01\x02\x03\x04", 2, 4, 1),
    (b"\x09" * 13, 3, 4, 3),
    (bytes(range(60)), 2, 1, 0),  # two-block tail
]


@pytest.mark.parametrize("backend_name", ["torch", "cuda"])
@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_driver_matches_jax_search_and_python_oracle(backend_name, case):
    nonce, d, workers, idx = case
    tbs = thread_bytes(idx, worker_bits(workers))
    got = _port_search(backend_name, nonce, d, tbs)
    want = jax_search(nonce, d, tbs, batch_size=BATCH, launch_candidates=LAUNCH)
    assert got.secret == want.secret
    assert got.hashes_tried == want.hashes_tried
    assert got.thread_byte == want.thread_byte and got.chunk == want.chunk
    assert got.secret == puzzle.python_search(nonce, d, tbs)
    assert hashlib.md5(nonce + got.secret).hexdigest().endswith("0" * d)
    # the backend's own entry point returns the same secret
    be = get_backend(backend_name, device="cpu", batch_size=BATCH, max_launch=LAUNCH)
    assert be.search(nonce, d, tbs) == got.secret


def test_difficulty_zero_first_candidate_wins():
    be = get_backend("cuda", device="cpu", batch_size=BATCH, max_launch=LAUNCH)
    assert be.search(b"\x01", 0, thread_bytes(2, worker_bits(4))) == bytes([128])


def test_cancel_check_returns_none_and_counts():
    m = Metrics()
    res = search(b"\x01\x02", 16, range(256), batch_size=BATCH, launch_candidates=LAUNCH,
                 device="cpu", metrics=m, cancel_check=lambda: True)
    assert res is None
    assert m.get("search.cancelled") == 1 and m.get("search.launches") == 0


def test_cancel_after_launches_flushes_inflight_counts():
    m = Metrics()
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 3

    res = search(b"\x01\x02", 16, range(256), batch_size=BATCH, launch_candidates=LAUNCH,
                 device="cpu", metrics=m, cancel_check=cancel)
    assert res is None
    # every dispatched launch is counted, drained or not
    assert m.get("search.launches") == 3
    assert m.get("search.hashes") > 0 and m.get("search.cancelled") == 1


def test_max_hashes_budget_stops():
    m = Metrics()
    res = search(b"\x01\x02", 16, range(256), batch_size=BATCH, launch_candidates=LAUNCH,
                 device="cpu", metrics=m, max_hashes=1)
    assert res is None


def test_unsatisfiable_difficulty():
    with pytest.raises(ValueError, match="unsatisfiable"):
        search(b"\x01", 33, range(256), device="cpu")
    assert search(b"\x01", 33, range(256), device="cpu", cancel_check=lambda: True) is None


def test_non_contiguous_thread_bytes_raise():
    with pytest.raises(ValueError, match="contiguous"):
        search(b"\x01", 1, [0, 2], device="cpu")


def test_found_counts_metrics():
    m = Metrics()
    res = search(b"\x01\x02\x03\x04", 2, range(256), batch_size=BATCH,
                 launch_candidates=LAUNCH, device="cpu", metrics=m)
    assert res is not None
    assert m.get("search.found") == 1
    assert m.get("search.blocking_syncs") >= 1
    assert m.get_observed("search.launch_s")["count"] == m.get("search.blocking_syncs")


def test_python_backend_matches_oracle():
    be = get_backend("python")
    tbs = thread_bytes(0, worker_bits(1))
    assert be.search(b"\x01\x02\x03\x04", 2, tbs) == puzzle.python_search(
        b"\x01\x02\x03\x04", 2, tbs)


def test_puzzle_helpers_match_jax_package():
    import numpy as np

    from distpow_tpu.models import puzzle as ref

    rng = np.random.default_rng(11)
    for n in (0, 1, 255, 256, 65535, 65536, 1 << 24):
        assert puzzle.int_to_chunk(n) == ref.int_to_chunk(n)
        assert puzzle.chunk_width(n) == ref.chunk_width(n)
        assert puzzle.chunk_to_int(puzzle.int_to_chunk(n)) == n
        chunk = bytearray(puzzle.int_to_chunk(n))
        assert puzzle.next_chunk(chunk) == ref.next_chunk(bytearray(puzzle.int_to_chunk(n)))
    for _ in range(50):
        nonce = rng.integers(0, 256, size=int(rng.integers(0, 70)), dtype=np.uint8).tobytes()
        secret = rng.integers(0, 256, size=3, dtype=np.uint8).tobytes()
        h = puzzle.hash_hex(nonce, secret)
        assert h == ref.hash_hex(nonce, secret) == hashlib.md5(nonce + secret).hexdigest()
        n0 = puzzle.count_trailing_zero_chars(h)
        assert n0 == puzzle.count_trailing_zero_nibbles(bytes.fromhex(h))
        assert puzzle.check_secret(nonce, secret, n0) and not puzzle.check_secret(
            nonce, secret, n0 + 1)
    assert list(itertools.islice(puzzle.iter_candidates([3, 4], start=255), 4)) == [
        (255, 3, b"\x03\xff"), (255, 4, b"\x04\xff"), (256, 3, b"\x03\x00\x01"),
        (256, 4, b"\x04\x00\x01")]
