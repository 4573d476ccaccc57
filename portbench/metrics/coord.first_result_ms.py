"""Coordinator: the window's mean time from a round's fan-out to its first
result (``coord.first_result_s``, ``nodes/coordinator.py``), in ms."""

from portbench.window import hist_delta


def read(window):
    count, total = hist_delta(window.coordinator, "coord.first_result_s")
    return total / count * 1e3 if count else None
