"""Faults planted in a worker process, to show that the check of the
answers catches them.  The benchmark's own runs plant none: the control
runs and the tests pass ``--fault NAME`` to ``run.py``, which hands it to
each worker's launcher.  A fault is installed before the worker boots and
acts only once ``ARMED`` is set, when the measured window opens, so the
warm-up runs sound.

* ``easy``: the control.  The search solves each puzzle one hex digit
  short of its difficulty, so it breaks the guarantee the configuration
  states (a secret's digest ends in ``ntz`` zero digits).
* ``answer``: the secret is altered where the search produces it.
* ``half``: every other search gives up without an answer.
* ``exchange``: the workers but the first drop their share of each
  fan-out, so the exchange between the coordinator and the other cards
  is left out.
"""

from __future__ import annotations

import itertools
import threading

ARMED = threading.Event()
NAMES = ("easy", "answer", "half", "exchange")


def install(name: str) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
    from distpow_tpu_torch.nodes import worker as node

    if name == "exchange":
        mine = node.WorkerRPCHandler.Mine

        def dropping_mine(self, params):
            if ARMED.is_set() and int(params.get("worker_byte", 0)) != 0:
                return {}
            return mine(self, params)

        node.WorkerRPCHandler.Mine = dropping_mine
        return

    get_backend = node.get_backend
    calls = itertools.count()

    def faulty_backend(*args, **kwargs):
        backend = get_backend(*args, **kwargs)
        search = backend.search

        def faulty_search(nonce, difficulty, thread_bytes, cancel_check=None):
            if not ARMED.is_set():
                return search(nonce, difficulty, thread_bytes, cancel_check=cancel_check)
            if name == "easy":
                return search(nonce, max(0, difficulty - 1), thread_bytes,
                              cancel_check=cancel_check)
            if name == "half" and next(calls) % 2:
                return None
            secret = search(nonce, difficulty, thread_bytes, cancel_check=cancel_check)
            if name == "answer" and secret is not None:
                secret = secret[:-1] + bytes([secret[-1] ^ 1])
            return secret

        backend.search = faulty_search
        return backend

    node.get_backend = faulty_backend
