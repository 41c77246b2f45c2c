"""moe_bwd_ms: self time of the program's ``moe.bwd`` spans (the
gradient's way through each expert layer, less the layer's recompute,
which runs nested in it), on the card's clock, per step."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("moe.bwd")
    if not row or not row["calls"] or not run["steps"]:
        return None
    return row["self_ms"] / run["steps"]
