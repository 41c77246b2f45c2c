"""moe_fwd_ms: device time inside the ``moe`` span (routing, dispatch,
expert products and combine; forward and recompute), per step."""
SPAN = "perfbench.moe"


def read(run):
    span = run["trace"]["spans"].get(SPAN)
    if not span or not span["calls"] or span["device_s"] <= 0:
        return None
    return span["device_s"] / run["steps"] * 1e3
