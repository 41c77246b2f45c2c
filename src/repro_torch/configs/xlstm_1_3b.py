"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks (xLSTM[7:1]).

48L d_model=2048 4H d_ff=0 vocab=50304 [arXiv:2405.04517].  One sLSTM
block per 8 (6 sLSTM total); mLSTM matrix memory gives O(1)-state
decode, so long_500k runs recurrently.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,
)
