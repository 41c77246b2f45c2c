"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf].  The speech frontend is a STUB: input_specs()
provides precomputed frame embeddings; encoder/decoder backbones are
real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    enc_seq=1536,
    frontend="audio",
)
