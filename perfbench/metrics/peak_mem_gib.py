"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
after a reset at its start, in GiB."""


def read(run):
    peak = run["device"].get("memory_peak_bytes")
    if not peak:
        return None
    return peak / 2 ** 30
