"""attention_bwd_ms: self time of the program's ``attention.bwd`` spans
(the gradient's way through each self-attention call, less any recompute
nested in it), on the card's clock, per step."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("attention.bwd")
    if not row or not row["calls"] or not run["steps"]:
        return None
    return row["self_ms"] / run["steps"]
