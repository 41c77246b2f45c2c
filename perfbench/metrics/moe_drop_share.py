"""moe_drop_share: assignments dropped past capacity over all
assignments, from the program's ``moe.dropped`` and ``moe.assignments``
counters over the window's forward passes, in %."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    c = spans.summary()["counters"]
    if not c.get("moe.assignments"):
        return None
    return 100.0 * c.get("moe.dropped", 0.0) / c["moe.assignments"]
