"""kimi-k2-instruct [moe, latent]: the published Kimi K2 architecture.

61L d_model=7168 64H; MLA with q / kv ranks 1536 / 512, qk head dims
128 (no rope) + 64 (rope), v head dim 128; layer 0 a dense SwiGLU of
18432, then 60 expert layers of 384 routed experts of width 2048, top-8
by sigmoid scores (with a selection bias), gates normalised and scaled
by 2.827, and one shared expert; vocab 163840, untied; YaRN rope
(theta 50000, factor 32 over 4096)
[hf:moonshotai/Kimi-K2-Instruct, config.json].  Not in ``ARCH_IDS``:
the JAX package has no such model (its ``kimi-k2-1t-a32b`` is a GQA
paper-table row).
"""
from repro_torch.configs.base import LatentConfig

CONFIG = LatentConfig(
    name="kimi-k2-instruct",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=64,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    top_k=8,
    rope_theta=50000.0,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_shared_experts=1,
    first_k_dense=1,
    dense_d_ff=18432,
    routed_scale=2.827,
    router_experts=384,
    expert_offset=0,
    yarn_factor=32.0,
    yarn_original=4096,
    yarn_beta_fast=1.0,
    yarn_beta_slow=1.0,
    yarn_mscale_all_dim=1.0,
)
