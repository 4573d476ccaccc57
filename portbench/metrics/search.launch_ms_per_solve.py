"""Driver: the host's time blocked on the search driver's launches
(``parallel/search.py``: ``search.launch_s``, the serial fetch, and
``search.poll_s``, the persistent loop's polls), summed over the workers'
threads, per verified solve of the window, in ms."""


def read(window):
    if not window.solves:
        return None
    blocked = window.workers_hist("search.launch_s")[1] + window.workers_hist("search.poll_s")[1]
    return blocked / len(window.solves) * 1e3
