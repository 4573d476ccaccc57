"""Trace action records — the observable protocol vocabulary.

The reference's distributed tracing is its correctness oracle (SURVEY.md
section 4): every protocol state transition records a typed action into a
causally-ordered trace.  These dataclasses mirror the reference's action
structs one-to-one so trace parity can be checked field by field:

* powlib actions:      powlib/powlib.go:13-39
* coordinator actions: coordinator.go:32-60
* worker actions:      worker.go:25-50
* cache actions:       cache.go:3-24

``nonce``/``secret`` are byte sequences, ``num_trailing_zeros`` the nibble
difficulty, ``worker_byte`` the worker's partition index.

Field-name parity: Python attributes stay snake_case
(idiomatic), but ``to_fields()`` — the dict that reaches every trace log —
emits the Go structs' exported CamelCase names (``Nonce``,
``NumTrailingZeros``, ``WorkerByte``, ``Secret``) in declaration order, so
a recorded action line is field-for-field the shape the reference's
structs serialize to.  Byte slices are emitted as integer lists (Go's
``%v`` rendering of ``[]uint8``); note that Go's ``encoding/json`` would
base64 a ``[]byte`` — untestable here either way (no Go toolchain, the
DistributedClocks library is not vendored), so the readable form wins.

The port's own copy of the reference's ``runtime/actions.py``
(``distpow_tpu/runtime/actions.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Tuple, Type


def _b(x) -> Tuple[int, ...]:
    return tuple(x) if x is not None else None


def _go_name(snake: str) -> str:
    """snake_case attribute -> the Go struct's exported CamelCase field."""
    return "".join(part.capitalize() for part in snake.split("_"))


@dataclass(frozen=True)
class Action:
    """Base trace action; ``name`` is the record type in logs."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def to_fields(self) -> Dict:
        d = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (bytes, bytearray)):
                v = list(v)
            d[_go_name(f.name)] = v
        return d


# --- powlib (client library) actions, powlib/powlib.go:13-39 ---------------

@dataclass(frozen=True)
class PowlibMiningBegin(Action):
    nonce: bytes
    num_trailing_zeros: int


@dataclass(frozen=True)
class PowlibMine(Action):
    nonce: bytes
    num_trailing_zeros: int


@dataclass(frozen=True)
class PowlibSuccess(Action):
    nonce: bytes
    num_trailing_zeros: int
    secret: bytes


@dataclass(frozen=True)
class PowlibMiningComplete(Action):
    nonce: bytes
    num_trailing_zeros: int
    secret: bytes


# --- coordinator actions, coordinator.go:32-60 ------------------------------

@dataclass(frozen=True)
class CoordinatorMine(Action):
    nonce: bytes
    num_trailing_zeros: int


@dataclass(frozen=True)
class CoordinatorWorkerMine(Action):
    nonce: bytes
    num_trailing_zeros: int
    worker_byte: int


@dataclass(frozen=True)
class CoordinatorWorkerResult(Action):
    nonce: bytes
    num_trailing_zeros: int
    worker_byte: int
    secret: bytes


@dataclass(frozen=True)
class CoordinatorWorkerCancel(Action):
    nonce: bytes
    num_trailing_zeros: int
    worker_byte: int


@dataclass(frozen=True)
class CoordinatorSuccess(Action):
    nonce: bytes
    num_trailing_zeros: int
    secret: bytes


# --- worker actions, worker.go:25-50 ----------------------------------------

@dataclass(frozen=True)
class WorkerMine(Action):
    nonce: bytes
    num_trailing_zeros: int
    worker_byte: int


@dataclass(frozen=True)
class WorkerResult(Action):
    nonce: bytes
    num_trailing_zeros: int
    worker_byte: int
    secret: bytes


@dataclass(frozen=True)
class WorkerCancel(Action):
    nonce: bytes
    num_trailing_zeros: int
    worker_byte: int


# --- cache actions, cache.go:3-24 -------------------------------------------

@dataclass(frozen=True)
class CacheAdd(Action):
    nonce: bytes
    num_trailing_zeros: int
    secret: bytes


@dataclass(frozen=True)
class CacheRemove(Action):
    nonce: bytes
    num_trailing_zeros: int
    secret: bytes


@dataclass(frozen=True)
class CacheHit(Action):
    nonce: bytes
    num_trailing_zeros: int
    secret: bytes


@dataclass(frozen=True)
class CacheMiss(Action):
    nonce: bytes
    num_trailing_zeros: int


ACTION_TYPES: Dict[str, Type[Action]] = {
    cls.__name__: cls
    for cls in (
        PowlibMiningBegin, PowlibMine, PowlibSuccess, PowlibMiningComplete,
        CoordinatorMine, CoordinatorWorkerMine, CoordinatorWorkerResult,
        CoordinatorWorkerCancel, CoordinatorSuccess,
        WorkerMine, WorkerResult, WorkerCancel,
        CacheAdd, CacheRemove, CacheHit, CacheMiss,
    )
}
