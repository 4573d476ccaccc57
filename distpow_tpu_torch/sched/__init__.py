"""The continuous-batching scheduler of the port.

* ``engine`` — ``BatchingScheduler``: one device loop packs many concurrent
  searches (slots) into shared launches, with the reference's fairness
  clock, preemption and join/leave at launch boundaries (the reference's
  ``distpow_tpu/sched/engine.py``).
* ``lanes``  — ``LanePlanner``: which device form serves a launch group,
  the group kernel (``cuda``) or the plain step (``torch``).

The reference's ``admission`` and ``coalesce`` modules are coordinator-side
and not ported yet.  ``BatchingScheduler`` loads lazily, as in the
reference.
"""

__all__ = ["BatchingScheduler"]


def __getattr__(name):
    if name == "BatchingScheduler":
        from .engine import BatchingScheduler

        return BatchingScheduler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
