"""shared_expert_ms: inclusive time of the program's ``moe.shared`` spans
(the shared expert of each expert layer; forward and recompute), on the
card's clock, per step."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("moe.shared")
    if not row or not row["calls"] or not run["steps"]:
        return None
    return row["ms"] / run["steps"]
