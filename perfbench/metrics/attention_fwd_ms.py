"""attention_fwd_ms: device time of the kernels launched inside the
``self_attention`` span (its forward and its recompute; not its backward),
per step."""
SPAN = "perfbench.self_attention"


def read(run):
    span = run["trace"]["spans"].get(SPAN)
    if not span or not span["calls"] or span["device_s"] <= 0:
        return None
    return span["device_s"] / run["steps"] * 1e3
