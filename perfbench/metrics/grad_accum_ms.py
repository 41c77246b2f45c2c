"""grad_accum_ms: inclusive time of the program's ``train.accumulate``
spans (each microbatch's gradients added into float32 and the division
by the microbatches), on the card's clock, per step."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("train.accumulate")
    if not row or not row["calls"] or not run["steps"]:
        return None
    return row["ms"] / run["steps"]
