"""Model/shape configuration dataclasses for the assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture from the assigned pool (exact figures in each
    ``configs/<id>.py``).  ``family`` selects the block assembly:
    dense | moe | hybrid (Mamba2+shared attn) | ssm (xLSTM) |
    encdec | vlm.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / Mamba2 (hybrid family) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    attn_every: int = 0               # shared attn applied every k blocks
    # --- xLSTM ---
    slstm_every: int = 0              # one sLSTM block every k blocks
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_seq: int = 1536               # audio frames fed to the encoder
    # --- VLM ---
    cross_attn_every: int = 0
    vision_tokens: int = 0
    vision_dim: int = 1280            # stub frontend embedding width
    # --- misc ---
    frontend: str = "none"            # none | audio | vision
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # long-context decode strategy for the attention component:
    # "full" (KV cache = context), "window" (sliding window KV).
    long_attention: str = "full"
    window: int = 4096
    # --- beyond-paper perf knobs (EXPERIMENTS.md §Perf) ---
    seq_parallel: bool = False        # Megatron-SP residual sharding
    moe_quant_dispatch: bool = False  # int8 expert all-to-all payloads
    kv_cache_dtype: str = "bfloat16"  # "int8" halves decode cache traffic

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_decoder_only(self) -> bool:
        return self.family not in ("encdec",)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            cross_attn_every=min(self.cross_attn_every, 2)
            if self.cross_attn_every else 0,
            slstm_every=min(self.slstm_every, 2)
            if self.slstm_every else 0,
            enc_seq=32,
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens
            else 0,
            vision_dim=64,
            window=64,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape x step-kind) cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"
    microbatches: int = 1      # gradient-accumulation steps (train only)


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per DESIGN.md §4."""
    if shape.name == "long_500k":
        if cfg.family in ("hybrid", "ssm"):
            return True, ""
        return False, ("full-attention architecture: 500k dense decode is "
                       "the quadratic regime the spec says to skip")
    return True, ""
