"""recompute_ms: inclusive time of the program's ``layer.recompute``
spans (each checkpointed layer's forward rerun in the backward), on the
card's clock, per step."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("layer.recompute")
    if not row or not row["calls"] or not run["steps"]:
        return None
    return row["ms"] / run["steps"]
