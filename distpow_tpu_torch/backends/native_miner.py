"""ctypes binding for the native C++ CPU miner (backends/native/).

The native library is built at first use with g++ (no external
dependencies), with the reference Makefile's flags (``CXX_FLAGS``), into
the port's build directory: ``ops/_build.BUILD_DIR``, which
``$DISTPOW_TORCH_BUILD_DIR`` or the worker's ``CompilationCacheDir`` sets,
never the source tree.  The library's file name carries a hash of the
source, the compiler, the flags and the host CPU (``-march=native`` makes
the code differ from host to host), so a stale build or one made for
another CPU is never loaded.  This is the CPU-performance counterpart of
the reference's Go worker loop for BASELINE.md configs 1-2 — same
enumeration contract as every other backend, verified against the
hashlib oracle in tests/test_torch_native.py.

The port's own copy of the reference's ``backends/native_miner.py``
(``distpow_tpu/backends/native_miner.py``): it imports nothing of the JAX
package, and no ``torch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from typing import Callable, Optional, Sequence

from ..models import puzzle
from ..ops import _build
from ..parallel.partition import contiguous_bounds
from ..runtime.metrics import REGISTRY as metrics

log = logging.getLogger("distpow.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
SOURCE = os.path.join(_NATIVE_DIR, "native_miner.cc")
# the reference Makefile's compiler and CXXFLAGS
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-march=native")
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build in this process took (0.0: the library was built
# already)
last_build_s = 0.0


class NativeUnavailable(RuntimeError):
    pass


def _host_cpu() -> bytes:
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for), from ``/proc/cpuinfo``; empty where it is unreadable."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().split(b"\n")
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.split(b":")[0].strip() in (b"model name", b"flags")]
    return b"\n".join(sorted(set(keep)))


def library_path() -> str:
    """Where the library of the source's current contents, built with
    this compiler and these flags for this host's CPU, lives."""
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(_host_cpu())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_build.BUILD_DIR, f"libdistpow_native_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the library unless it is built already; return its path.
    The caller holds ``_lib_lock``.  The compile writes a file of its own
    and renames it into place, so processes that build at once never load
    a half-written library."""
    global last_build_s
    path = library_path()
    last_build_s = 0.0
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE]
    t0 = time.monotonic()
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as exc:
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeUnavailable(
            f"failed to build native miner ({' '.join(cmd)}): {detail}"
        ) from exc
    os.replace(tmp, path)
    last_build_s = time.monotonic() - t0
    log.info("built %s in %.1f s", path, last_build_s)
    return path


ALGO_IDS = {"md5": 0, "sha256": 1, "sha1": 2, "ripemd160": 3,
            "sha512": 4, "sha384": 5, "sha3_256": 6, "blake2b_256": 7,
            "sha256d": 8}

# Digest sizes (bytes) for the native algorithms, fixed by RFC 1321 /
# FIPS 180-4.  max difficulty = hex nibbles = 2 * digest bytes; kept
# local (mirroring the C library's own rc=-2 guard) so the native hot
# path never imports the device model modules (resolving
# max_difficulty via models.registry would pull torch into native-only use).
DIGEST_BYTES = {"md5": 16, "sha256": 32, "sha1": 20, "ripemd160": 20,
                "sha512": 64, "sha384": 48, "sha3_256": 32,
                "blake2b_256": 32, "sha256d": 32}


def load_library(build: bool = True) -> ctypes.CDLL:
    """Load (building if needed) the native miner library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path) and build:
            # distpow: ok transitive-blocking-under-lock -- one-shot lazy
            # build under the load lock is the point: concurrent
            # first-callers must block until the single g++ finishes
            # rather than race parallel builds of the same .so
            build_library()
        if not os.path.exists(path):
            raise NativeUnavailable(f"native miner library missing: {path}")
        lib = ctypes.CDLL(path)
        lib.distpow_search_range.restype = ctypes.c_int
        lib.distpow_search_range.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,          # nonce
            ctypes.c_uint32,                            # difficulty
            ctypes.c_uint32,   # algo: 0 md5, 1 sha256, 2 sha1,
                               # 3 ripemd160, 4 sha512, 5 sha384,
                               # 6 sha3_256, 7 blake2b_256
            ctypes.c_char_p, ctypes.c_size_t,          # thread bytes
            ctypes.c_uint32,                            # width
            ctypes.c_uint64, ctypes.c_uint64,          # chunk start/count
            ctypes.c_int32,                             # n_threads
            ctypes.POINTER(ctypes.c_int32),            # cancel flag
            ctypes.POINTER(ctypes.c_uint64),           # out hashes
            ctypes.c_char_p,                            # out secret
        ]
        for model in ALGO_IDS:
            fn = getattr(lib, f"distpow_{model}")
            fn.restype = None
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        _lib = lib
        return lib


def native_digest(model: str, data: bytes) -> bytes:
    """``model``'s digest of ``data`` computed by the native library."""
    lib = load_library()
    out = ctypes.create_string_buffer(DIGEST_BYTES[model])
    getattr(lib, f"distpow_{model}")(data, len(data), out)
    return out.raw


def _digest_function(model: str) -> Callable[[bytes], bytes]:
    def digest(data: bytes) -> bytes:
        return native_digest(model, data)
    digest.__name__ = digest.__qualname__ = f"native_{model}"
    return digest


# native_md5, native_sha256, ... : the reference's per-model names
for _model in DIGEST_BYTES:
    globals()[f"native_{_model}"] = _digest_function(_model)
del _model


class NativeBackend:
    """C++ brute-force miner behind the standard backend interface."""

    name = "native"

    def __init__(
        self,
        hash_model: str = "md5",
        n_threads: int = 0,
        range_size: int = 1 << 22,
        **_,
    ):
        if hash_model not in ALGO_IDS:
            raise ValueError(
                f"native backend implements {sorted(ALGO_IDS)}, "
                f"not {hash_model!r}"
            )
        self.hash_model = hash_model
        self.algo = ALGO_IDS[hash_model]
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self.range_size = range_size
        self.lib = load_library()

    def search(
        self,
        nonce: bytes,
        difficulty: int,
        thread_bytes: Sequence[int],
        cancel_check: Optional[Callable[[], bool]] = None,
    ) -> Optional[bytes]:
        nonce = bytes(nonce)
        max_nibbles = 2 * DIGEST_BYTES[self.hash_model]
        if difficulty > max_nibbles:
            if cancel_check is None:
                # same guard as parallel/search.py:
                # with no gate the block below could never return
                raise ValueError(
                    f"difficulty {difficulty} exceeds {self.hash_model}'s "
                    f"{max_nibbles} digest nibbles (unsatisfiable) and no "
                    f"cancel_check was supplied; the search could never "
                    f"return"
                )
            # unsatisfiable: same contract as the device driver
            # (parallel/search.py) — the reference would brute-force
            # forever, so block on the cancel gate instead of burning
            # CPU (the C library also guards with rc=-2, so an
            # out-of-range difficulty can never over-read the digest
            # buffer in MeetsDifficulty).  cancel_check is non-None
            # here: the guard above raised otherwise.
            while True:
                if cancel_check():
                    metrics.inc("search.cancelled")
                    return None
                time.sleep(0.01)
        contiguous_bounds(thread_bytes)  # validates the run
        tb_buf = bytes(thread_bytes)
        cancel = ctypes.c_int32(0)
        hashes = ctypes.c_uint64(0)
        secret_buf = ctypes.create_string_buffer(16)

        stop_poll = threading.Event()
        if cancel_check is not None:
            # mirror the driver's between-batches poll as a tiny side thread
            # flipping the native cancel flag
            def poll():
                while not stop_poll.is_set():
                    if cancel_check():
                        cancel.value = 1
                        return
                    stop_poll.wait(0.01)

            threading.Thread(target=poll, daemon=True).start()

        def account() -> None:
            # the native call OVERWRITES its out-param each invocation
            # (*out_hashes = hashes, native_miner.cc) — per-call totals,
            # not accumulation
            metrics.inc("search.hashes", hashes.value)
            metrics.inc("search.launches")

        try:
            # the native path enumerates full-width chunk integers in
            # uint64 directly, so each width is one dense range (no
            # high-byte segmenting like the uint32-lane device kernels)
            for width in range(0, 8):
                full_lo, full_hi = (
                    (0, 1) if width == 0
                    else (256 ** (width - 1), 256 ** width)
                )
                start = full_lo
                while start < full_hi:
                    count = min(self.range_size, full_hi - start)
                    rc = self.lib.distpow_search_range(
                        nonce, len(nonce),
                        difficulty, self.algo,
                        tb_buf, len(tb_buf),
                        width,
                        start, count,
                        self.n_threads,
                        ctypes.byref(cancel),
                        ctypes.byref(hashes),
                        secret_buf,
                    )
                    account()
                    if rc == 1:
                        secret = secret_buf.raw[: 1 + width]
                        if not puzzle.check_secret(nonce, secret, difficulty,
                                                   algo=self.hash_model):
                            raise RuntimeError(
                                "native miner returned non-solving secret "
                                f"{secret.hex()}"
                            )
                        metrics.inc("search.found")
                        return secret
                    if rc == -1:
                        metrics.inc("search.cancelled")
                        return None
                    if rc < 0:
                        raise RuntimeError(f"native miner error rc={rc}")
                    start += count
            return None
        finally:
            stop_poll.set()
