"""mfu: model FLOPs of the window's steps (6 x the weights a token touches,
active experts and head included, plus the causal half of attention; no
recomputation) over the traced window's time at the card's dense bf16
peak, in %."""
from perfbench.yardstick import flops


def read(run):
    window = run["trace"]["window_s"]
    if window <= 0 or not run["steps"]:
        return None
    per_token = flops.model_flops_per_token(run["spec"], run["mix"]["seq_len"])
    done = per_token * run["tokens_per_step"] * run["steps"]
    return 100.0 * done / window / flops.PEAK_BF16_FLOPS
