"""kimi-k2-1t-a32b [moe]: trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840,
384 experts top-8 [arXiv:2501.kimi2].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    top_k=8,
)
