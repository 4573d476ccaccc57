"""The worker's side of the elastic fleet (the reference's
``distpow_tpu/fleet/``, docs/FLEET.md).

* :mod:`.capability` — the capability advertisement a worker registers
  with (backend, hash models, measured MH/s from a short
  self-calibration, scheduler slot width);
* :mod:`.agent` — the worker-side agent: self-calibrate, register,
  heartbeat, re-register after a lease loss, drain on shutdown.

The coordinator's side (the reference's ``fleet/membership.py``: the lease
registry and the ``Fleet`` RPC service) comes with the coordinator.
"""

from .agent import FleetAgent
from .capability import Capability, calibrate_mhs

__all__ = ["Capability", "calibrate_mhs", "FleetAgent"]
