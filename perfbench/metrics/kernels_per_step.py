"""kernels_per_step: device operations (kernels, copies, fills) the
profiler saw in the window, per step."""


def read(run):
    n = run["trace"]["device_ops"]
    if not n:
        return None
    return n / run["steps"]
