"""The sizes, draws and counts of a latent-attention configuration (Kimi K2,
DeepSeek-V3), as the benchmark reads them.

``configs/<name>.json`` keeps the base keys under ``model`` (what
:class:`~perfbench.yardstick.spec.Spec` and the port's base config read)
and the rest under ``latent``; :class:`LatentSpec` is both.  The counts
here are what ``mfu_latent`` and ``mla_roofline`` divide by: the work the
model needs, whatever implements it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from perfbench.yardstick import weights
from perfbench.yardstick.spec import Spec

#: norm weights of the latent layers that ``weights.NORMS`` does not name
NORMS = ("kv_norm",)


@dataclasses.dataclass(frozen=True)
class LatentSpec(Spec):
    """``n_experts`` experts are held here of ``router_experts``, from
    ``expert_offset`` on; ``d_ff`` is an expert's width."""

    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    routed_scale: float = 1.0
    router_experts: int = 0
    expert_offset: int = 0
    yarn_factor: float = 1.0
    yarn_original: int = 4096
    yarn_beta_fast: float = 1.0
    yarn_beta_slow: float = 1.0
    yarn_mscale_all_dim: float = 1.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @classmethod
    def from_config(cls, config: Dict) -> "LatentSpec":
        """A config file's ``model`` and ``latent`` blocks."""
        return cls(**config["model"], **config["latent"])


@torch.no_grad()
def fill(dest: Dict[str, torch.Tensor], seed: int,
         stated: Callable[[str], torch.dtype]) -> None:
    """:func:`weights.fill`, then the latent norm weights set to ones."""
    weights.fill(dest, seed, stated)
    for name, t in dest.items():
        if name.rsplit(".", 1)[-1] in NORMS:
            t.fill_(1)


def attention_weights(s: LatentSpec) -> int:
    """The five projection matrices of one latent-attention layer."""
    d, h = s.d_model, s.n_heads
    return (d * s.q_lora_rank + s.q_lora_rank * h * s.qk_head_dim
            + d * (s.kv_lora_rank + s.qk_rope_head_dim)
            + s.kv_lora_rank * h * (s.qk_nope_head_dim + s.v_head_dim)
            + h * s.v_head_dim * d)


def param_count(s: LatentSpec) -> int:
    """Every weight held here: layers (norms included), embedding, head."""
    d, f = s.d_model, s.d_ff
    attn = attention_weights(s) + s.q_lora_rank + s.kv_lora_rank + 2 * d
    dense = attn + 3 * d * s.dense_d_ff
    expert = attn + d * s.router_experts \
        + (s.n_experts + s.n_shared_experts) * 3 * d * f
    n_moe = s.n_layers - s.first_k_dense
    return s.first_k_dense * dense + n_moe * expert + 2 * s.vocab * d + d


def touched_weights(s: LatentSpec) -> float:
    """Weights a token multiplies on this device: every attention, the
    dense MLPs, each expert layer's router and shared expert, its top-k
    experts' weights times the share of them held here, and the head;
    the embedding lookup is no product."""
    d, f = s.d_model, s.d_ff
    n_moe = s.n_layers - s.first_k_dense
    held = s.n_experts / s.router_experts
    per_moe = d * s.router_experts + s.n_shared_experts * 3 * d * f \
        + s.top_k * held * 3 * d * f
    return s.n_layers * attention_weights(s) \
        + s.first_k_dense * 3 * d * s.dense_d_ff + n_moe * per_moe \
        + s.vocab * d


def model_flops_per_token(s: LatentSpec, seq: int) -> float:
    """Training FLOPs a token: 6 x the weights it touches, plus the
    causal half of the scores (at ``nope + rope``) and of the values (at
    ``v``), 3 x L x T x H x (d_qk + d_v).  Recomputation is not
    counted."""
    return 6.0 * touched_weights(s) + 3.0 * s.n_layers * seq * s.n_heads \
        * (s.qk_head_dim + s.v_head_dim)


def mla_call(s: LatentSpec, batch: int, seq: int, act_bytes: int = 2,
             w_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal latent-attention call over ``batch``
    sequences of ``seq``: the five projections, the causal half of QK^T
    at ``nope + rope`` and of PV at ``v``; x, the weights and the output
    each read or written once."""
    n = batch * seq
    proj = 2.0 * n * attention_weights(s)
    scores = float(batch) * seq * seq * s.n_heads \
        * (s.qk_head_dim + s.v_head_dim)
    nbytes = 2.0 * n * s.d_model * act_bytes \
        + attention_weights(s) * w_bytes
    return proj + scores, nbytes
