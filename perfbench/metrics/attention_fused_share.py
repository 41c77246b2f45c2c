"""attention_fused_share: the program's causal attention calls that went
through the fused kernel, from its ``attention.fused`` and
``attention.calls`` counters over the window's forward passes (recompute
included), in %."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    c = spans.summary()["counters"]
    if not c.get("attention.calls"):
        return None
    return 100.0 * c.get("attention.fused", 0.0) / c["attention.calls"]
