"""optim_ms: device time inside the AdamW ``update`` span, per step."""
SPAN = "perfbench.update"


def read(run):
    span = run["trace"]["spans"].get(SPAN)
    if not span or not span["calls"] or span["device_s"] <= 0:
        return None
    return span["device_s"] / run["steps"] * 1e3
