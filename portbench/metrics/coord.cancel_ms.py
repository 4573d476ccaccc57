"""Coordinator: the window's mean cancel storm, from a round's first result
to the last worker's acknowledgement of ``Found``, in ms.
``coord.cancel_propagation_s`` runs from the fan-out, so the storm is its
window mean less that of ``coord.first_result_s`` (each over its own
rounds: a round may have its first result but not its last ACK when the
window closes)."""

from portbench.window import hist_delta


def read(window):
    count, cancel = hist_delta(window.coordinator, "coord.cancel_propagation_s")
    first_count, first = hist_delta(window.coordinator, "coord.first_result_s")
    if not count or not first_count:
        return None
    return (cancel / count - first / first_count) * 1e3
