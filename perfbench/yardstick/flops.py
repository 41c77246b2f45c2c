"""Operations and bytes the benchmark counts, frozen here.

``param_count`` and ``forward_flops`` are copies of the port's
``roofline/analysis.py`` functions of the same names, cut to the dense and
MoE families that :class:`~perfbench.yardstick.spec.Spec` models, with the
output head counted.  ``model_flops_per_token`` is what ``mfu`` divides by
and ``attention_call`` what ``attention_roofline`` divides by; both count
the work the model needs, whatever implements it.
"""
from __future__ import annotations

from typing import Tuple

from perfbench.yardstick.spec import Spec

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_S = 3.35e12


def _attn_params(s: Spec) -> int:
    return s.d_model * s.hd * (s.n_heads + 2 * s.n_kv_heads) \
        + s.n_heads * s.hd * s.d_model


def param_count(s: Spec) -> Tuple[int, int]:
    """(total, active-per-token) parameters, embedding and head included."""
    d, f = s.d_model, s.d_ff
    attn = _attn_params(s)
    if s.family == "dense":
        total = active = s.n_layers * (attn + 3 * d * f)
    elif s.family == "moe":
        router = d * s.n_experts
        expert = 3 * d * f
        total = s.n_layers * (attn + router + s.n_experts * expert)
        active = s.n_layers * (attn + router + s.top_k * expert)
    else:
        raise ValueError(f"family {s.family!r} is not counted here")
    emb = s.vocab * d * (1 if s.tie_embeddings else 2)
    return total + emb, active + emb


def forward_flops(s: Spec, n_tokens: float, ctx: float) -> float:
    """Forward FLOPs for ``n_tokens`` each attending over ``ctx`` (the
    port's count: full ``ctx`` attention, experts at the capacity factor),
    the head included."""
    d, hd = s.d_model, s.hd
    proj = 2 * d * hd * (s.n_heads + 2 * s.n_kv_heads) \
        + 2 * s.n_heads * hd * d
    attn = proj + 4 * s.n_heads * hd * ctx
    if s.family == "moe":
        ffn = 2 * d * s.n_experts + 6 * d * s.d_ff * s.top_k \
            * s.capacity_factor
    else:
        ffn = 6 * d * s.d_ff
    return n_tokens * (s.n_layers * (attn + ffn) + 2 * d * s.vocab)


def touched_weights(s: Spec) -> int:
    """Weights a token multiplies: every layer's (the active experts
    only) and the head's, tied or not; the embedding lookup is no
    product."""
    _, active = param_count(s)
    emb = s.vocab * s.d_model * (1 if s.tie_embeddings else 2)
    return active - emb + s.vocab * s.d_model


def model_flops_per_token(s: Spec, seq: int) -> float:
    """Training FLOPs a token: 6 x the weights it touches, plus the causal
    half of attention's 12 x L x T x d_attn, so 6 x L x T x d_attn.
    Recomputation is not counted."""
    return 6.0 * touched_weights(s) \
        + 6.0 * s.n_layers * seq * s.n_heads * s.hd


def attention_call(s: Spec, batch: int, seq: int,
                   act_bytes: int = 2, w_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal self-attention call over ``batch``
    sequences of ``seq``: the four projections and the causal half of the
    score and value products; x, the four weights and the output each
    read or written once."""
    d, hd, hq, hkv = s.d_model, s.hd, s.n_heads, s.n_kv_heads
    n = batch * seq
    proj = 2.0 * n * d * hd * (hq + 2 * hkv) + 2.0 * n * hq * hd * d
    scores = 2.0 * batch * seq * seq * hq * hd   # (QK^T + PV) / 2 each
    nbytes = 2.0 * n * d * act_bytes + _attn_params(s) * w_bytes
    return proj + scores, nbytes


def least_time_s(flops: float, nbytes: float) -> float:
    """The roofline's least time: the slower of compute and memory."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
