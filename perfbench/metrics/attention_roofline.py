"""attention_roofline: the least time for the work of every
``self_attention`` call in the window (its four projections and the causal
half of the score and value products, at the card's bf16 peak and HBM
bandwidth) over the device time inside those spans, in %."""
from perfbench.yardstick import flops

SPAN = "perfbench.self_attention"


def read(run):
    span = run["trace"]["spans"].get(SPAN)
    if not span or not span["calls"] or span["device_s"] <= 0:
        return None
    mix = run["mix"]
    rows = mix["batch"] // mix["microbatches"]
    work, nbytes = flops.attention_call(run["spec"], rows, mix["seq_len"])
    least = span["calls"] * flops.least_time_s(work, nbytes)
    return 100.0 * least / span["device_s"]
