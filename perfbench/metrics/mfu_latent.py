"""mfu_latent: model FLOPs of the window's steps for a latent-attention
configuration (6 x the weights a token touches on this card, the held
share of its experts and the head included, plus the causal half of the
scores at ``nope + rope`` and of the values at ``v``; no recomputation;
``yardstick/latent.py::model_flops_per_token``) over the traced window's
time at the card's dense bf16 peak, in %."""
from perfbench.yardstick import flops, latent


def read(run):
    spec = run["spec"]
    window = run["trace"]["window_s"]
    if not isinstance(spec, latent.LatentSpec) or window <= 0 \
            or not run["steps"]:
        return None
    per_token = latent.model_flops_per_token(spec, run["mix"]["seq_len"])
    done = per_token * run["tokens_per_step"] * run["steps"]
    return 100.0 * done / window / flops.PEAK_BF16_FLOPS
