"""moe_held_share: assignments to the experts held on this card over every
assignment the routers made, from the program's ``moe.assignments`` and
``moe.routed`` counters over the window's forward passes, in % (an even
routing over 8 of 384 experts gives 2.08 %)."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    c = spans.summary()["counters"]
    if not c.get("moe.routed"):
        return None
    return 100.0 * c.get("moe.assignments", 0.0) / c["moe.routed"]
