"""The port's nodes: the worker (``nodes/worker.py``).  The coordinator,
the client and powlib are the reference's until they are ported."""

from .worker import Worker, WorkerRPCHandler

__all__ = ["Worker", "WorkerRPCHandler"]
