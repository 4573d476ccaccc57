"""Device: the share of the window in which a card runs no operation, from
each worker's profile, averaged over the cards, in %."""


def read(window):
    profiles = [p for p in window.profiles if p["window_s"] > 0]
    if not profiles or not any(p["busy_s"] > 0 for p in profiles):
        return None
    return 100.0 * sum(1 - p["busy_s"] / p["window_s"] for p in profiles) / len(profiles)
