"""moe_slot_use: kept assignments over the E x C slots the expert products
compute, from every ``Routing`` that ``route`` returned in the window, in %."""


def read(run):
    routing = run.get("routing")
    if not routing or not routing["slots"]:
        return None
    return 100.0 * routing["kept"] / routing["slots"]
