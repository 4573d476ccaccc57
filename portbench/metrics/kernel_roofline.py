"""Kernels: the search kernels' share of the card's integer peak.

Work is the candidates each of the window's verified solves took, in the
reference's order, up to and including its secret (``reference.candidates``,
worked out from the secret itself), times the configuration's workers (each
searching its own share at the winner's pace) and its needed operations per
hash (``ops_per_hash``).  The bound is that work at the peak of
``peaks.json``; the share is the bound over the device time of the search
kernels (names matching ``KERNEL_PATTERN``) in the window's profiles, summed
over the cards."""

import re

KERNEL_PATTERN = re.compile(r"hash_\w*kernel")


def read(window):
    if not window.profiles or not window.peak or not window.solves:
        return None
    kernel_s = sum(s for p in window.profiles for name, s in p["device_ops"].items()
                   if KERNEL_PATTERN.search(name))
    if kernel_s <= 0:
        return None
    peak = window.peak
    ops_per_s = peak["int_ops_per_clock_per_sm"] * peak["sms"] * peak["clock_mhz"] * 1e6
    tried = sum(c for _, _, c in window.solves) * int(window.config["Workers"])
    return 100.0 * tried * window.config["ops_per_hash"] / ops_per_s / kernel_s
