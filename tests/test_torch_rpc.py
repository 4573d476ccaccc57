"""The port's RPC layer (``distpow_tpu_torch.runtime.rpc``) against the
reference's, in both directions: the port's ``RPCServer`` answers the
reference's ``RPCClient`` and the reference's server answers the port's
client, under the JSON codec, the negotiated binary codec and against a
server that does not negotiate.  Results, handler errors and the typed
``RPCRetryAfter`` cross intact; the ``Spans`` RPC and ``StatsOnly`` alias
answer the reference's client; the address helpers agree."""

import numpy as np
import pytest

from distpow_tpu.runtime import rpc as ref_rpc
from distpow_tpu_torch.runtime import rpc

SEED = 20261017
PACKAGES = {"port": rpc, "ref": ref_rpc}
# (server package, client package)
PAIRS = [("port", "ref"), ("ref", "port")]


class _Busy(Exception):
    """A handler refusal with server-paced backpressure (duck-typed
    ``retry_after_s``, as the scheduler's admission control raises)."""

    retry_after_s = 0.25


class Echo:
    def Ping(self, params):
        return {"got": params}

    def Fail(self, params):
        raise RuntimeError(f"boom {params.get('n')}")

    def Busy(self, params):
        raise _Busy("run queue full (2/2)")

    def Stats(self, params):
        return {"role": "echo", "counters": {"x": 1}}


def _serve(pkg, negotiate=True):
    srv = PACKAGES[pkg].RPCServer(negotiate=negotiate)
    srv.register("S", Echo())
    srv.register("Node", PACKAGES[pkg].StatsOnly(Echo()))
    addr = srv.listen("127.0.0.1:0")
    srv.serve_in_background()
    return srv, addr


def _payloads():
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(8):
        out.append({"nonce": rng.integers(0, 256, size=int(rng.integers(1, 17)),
                                          dtype=np.uint8).tobytes(),
                    "num_trailing_zeros": int(rng.integers(0, 33)),
                    "worker_byte": int(rng.integers(0, 256)), "round": f"{i:024x}",
                    "n": int(rng.integers(-2**40, 2**40)), "f": float(rng.normal()),
                    "l": [int(v) for v in rng.integers(0, 9, size=3)], "none": None})
    return out


@pytest.mark.parametrize("codec", ["json", "binary", "auto"])
@pytest.mark.parametrize("server,client", PAIRS)
def test_results_errors_and_retry_after_cross(server, client, codec):
    srv, addr = _serve(server)
    try:
        c = PACKAGES[client].RPCClient(addr, codec=codec)
        try:
            assert c.codec_name == ("json" if codec == "json" else "binary")
            for p in _payloads():
                got = c.call("S.Ping", p, timeout=10)["got"]
                if c.codec_name == "binary":
                    assert got == p
                else:
                    # the JSON wire renders bytes as the legacy int array
                    assert got == {**p, "nonce": list(p["nonce"])}
            with pytest.raises(PACKAGES[client].RPCError, match="RuntimeError: boom 7") as ei:
                c.call("S.Fail", {"n": 7}, timeout=10)
            assert type(ei.value) is PACKAGES[client].RPCError
            with pytest.raises(PACKAGES[client].RPCRetryAfter, match="run queue full") as ei:
                c.call("S.Busy", {}, timeout=10)
            assert ei.value.delay_s == 0.25
            with pytest.raises(PACKAGES[client].RPCError, match="unknown method"):
                c.call("S.Nope", {}, timeout=10)
            assert c.call("Node.Stats", {}, timeout=10)["role"] == "echo"
            with pytest.raises(PACKAGES[client].RPCError, match="unknown method"):
                c.call("Node.Ping", {}, timeout=10)
        finally:
            c.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("server,client", PAIRS)
def test_auto_falls_back_to_json_against_a_server_that_does_not_negotiate(server, client):
    srv, addr = _serve(server, negotiate=False)
    try:
        c = PACKAGES[client].RPCClient(addr)
        try:
            assert c.codec_name == "json"
            assert c.call("S.Ping", {"nonce": b"\xaa"}, timeout=10)["got"]["nonce"] == [170]
        finally:
            c.close()
        with pytest.raises(PACKAGES[client].RPCError):
            PACKAGES[client].RPCClient(addr, codec="binary")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("codec", ["json", "binary"])
def test_spans_rpc_answers_the_reference_client(codec):
    from distpow_tpu_torch.runtime.spans import SPANS

    srv, addr = _serve("port")
    SPANS.reset()
    try:
        SPANS.record("worker.solve", 1.0, 0.5, trace_id=77, node="worker1")
        c = ref_rpc.RPCClient(addr, codec=codec)
        try:
            out = c.call("Node.Spans", {"trace_id": 77}, timeout=10)
            assert [s["name"] for s in out["spans"]] == ["worker.solve"]
            assert c.call("Node.Spans", {}, timeout=10)["traces"][0]["trace_id"] == 77
        finally:
            c.close()
    finally:
        SPANS.reset()
        srv.shutdown()


@pytest.mark.parametrize("addr", ["127.0.0.1:80", ":5000", "localhost:0", "[::1]:7", "h:65535"])
def test_address_helpers_agree(addr):
    for fn in ("split_addr", "split_bind_addr"):
        try:
            want = getattr(ref_rpc, fn)(addr)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(rpc, fn)(addr)
        else:
            assert getattr(rpc, fn)(addr) == want
