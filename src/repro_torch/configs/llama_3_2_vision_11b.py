"""llama-3.2-vision-11b [vlm]: cross-attention image layers.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision].  Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings (vision_dim=1280);
the gated cross-attention layers (every 5th) and projector are real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    vision_tokens=1601,
    vision_dim=1280,
    frontend="vision",
    rope_theta=5e5,
)
