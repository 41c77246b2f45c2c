"""mla_roofline: the least time for the work of every latent-attention
call in the window (its five projections and the causal half of QK^T at
``nope + rope`` and of PV at ``v``, at the card's bf16 peak and HBM
bandwidth; ``yardstick/latent.py::mla_call``) over the inclusive time of
the program's ``attention.fwd`` spans (forward and recompute), in %."""
from perfbench.yardstick import flops, latent


def read(run):
    spec = run["spec"]
    if not isinstance(spec, latent.LatentSpec):
        return None
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("attention.fwd")
    if not row or not row["calls"] or row["ms"] <= 0:
        return None
    mix = run["mix"]
    rows = mix["batch"] // mix["microbatches"]
    work, nbytes = latent.mla_call(spec, rows, mix["seq_len"])
    least = row["calls"] * flops.least_time_s(work, nbytes)
    return 100.0 * least / (row["ms"] / 1e3)
