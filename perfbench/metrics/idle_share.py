"""idle_share: the share of the traced window in which no device operation
ran (1 minus the union of their intervals over the window), in %."""


def read(run):
    t = run["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
