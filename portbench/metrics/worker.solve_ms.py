"""Worker: the window's mean time from a worker's Mine to its solve
(``worker.solve_s``, ``nodes/worker.py``), over every worker, in ms."""


def read(window):
    count, total = window.workers_hist("worker.solve_s")
    return total / count * 1e3 if count else None
