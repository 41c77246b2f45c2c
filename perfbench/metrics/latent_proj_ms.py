"""latent_proj_ms: inclusive time of the program's ``attention.latent``
spans (each latent-attention call's down-projections, the two norms, the
up-projections and the decoupled rope, before the scores; forward and
recompute), on the card's clock, per step."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:         # a program without the span registry
        return None
    row = spans.summary()["spans"].get("attention.latent")
    if not row or not row["calls"] or not run["steps"]:
        return None
    return row["ms"] / run["steps"]
