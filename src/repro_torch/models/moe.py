"""Mixture-of-experts layer with capacity-based sparse dispatch.

The port of ``repro/models/moe.py``.  The dispatch is discrete, so it
follows the reference step for step: float32 router logits and
softmax, the top-k gates renormalised, each (token, k) assignment
ranked within its expert by one stable sort, ``keep = rank < capacity``,
and the kept assignments scattered into an ``[E * C + 1]`` slot table
whose last (sentinel) row takes the dropped ones and is cut off.
Experts then run as dense batched matmuls over ``[E, C, d]`` and the
gated outputs are combined with a float32 scatter-add (``index_add_``;
on CUDA its order of addition varies from run to run, so results agree
within rounding, not bit for bit).

``jax.lax.top_k`` takes the lower expert index among equal
probabilities; ``torch.topk`` promises no order among ties, so the port
takes the first k of a stable descending sort, which keeps the
reference's order on the CPU and on the card alike.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param


class MoE(nn.Module):
    """``router`` ``[d, E]`` (float32), ``w_gate`` / ``w_up``
    ``[E, d, f]``, ``w_down`` ``[E, f, d]``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param((d, e), torch.float32, device)
        self.w_gate = param((e, d, f), dtype, device)
        self.w_up = param((e, d, f), dtype, device)
        self.w_down = param((e, f, d), dtype, device)

    def reset(self, gen) -> None:
        d = self.router.shape[0]
        f = self.w_down.shape[1]
        for w, fan_in in ((self.router, d), (self.w_gate, d),
                          (self.w_up, d), (self.w_down, f)):
            w.copy_(dense_init(gen, w.shape, fan_in, w.dtype, w.device))


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cap, cfg.top_k)


class Routing(NamedTuple):
    """The discrete dispatch of ``n`` tokens (``A = n * k`` assignments)."""

    logits: torch.Tensor      # float32 [n, E] router logits
    probs: torch.Tensor       # float32 [n, E]
    gate_vals: torch.Tensor   # float32 [n, k], renormalised
    expert_ids: torch.Tensor  # int64 [n, k]
    keep: torch.Tensor        # bool [A]: assignment within capacity
    slot: torch.Tensor        # int64 [A]: table row, E * C if dropped
    table: torch.Tensor       # int64 [E, C]: token per slot, n if empty


def route(p: MoE, xf: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Router, top-k and the capacity-bounded slot table for ``xf``
    ``[n, d]``."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n, cfg)
    dev = xf.device
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = srt.values[:, :k], srt.indices[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # rank of each assignment within its expert (stable sort)
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    ranked = torch.empty_like(order)
    ranked[order] = torch.arange(n * k, device=dev)
    seg_start = torch.searchsorted(flat_e[order],
                                   torch.arange(e, device=dev))
    pos_in_expert = ranked - seg_start[flat_e]
    keep = pos_in_expert < cap

    # the [E * C + 1] slot table; the sentinel row takes the drops
    slot = torch.where(keep, flat_e * cap + pos_in_expert,
                       torch.full_like(flat_e, e * cap))
    token_of = torch.arange(n, device=dev).repeat_interleave(k)
    table = torch.full((e * cap + 1,), n, dtype=torch.long, device=dev)
    table[slot] = token_of
    return Routing(logits, probs, gate_vals, expert_ids, keep, slot,
                   table[:-1].reshape(e, cap))


def _slot_gate(gate_vals: torch.Tensor, keep: torch.Tensor,
               slot: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Gate weight aligned with the ``[E * C]`` slot table rows."""
    flat_g = gate_vals.reshape(-1)
    g = torch.zeros((e * cap + 1,), dtype=flat_g.dtype,
                    device=flat_g.device)
    g[slot] = torch.where(keep, flat_g, torch.zeros_like(flat_g))
    return g[:-1]


def _int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantisation: (values, float32 ``[.., 1]`` scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-9
    return torch.round(xf / scale).to(torch.int8), scale


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, d] -> (out [B, T, d], aux losses)."""
    b, t, d = x.shape
    n = b * t
    e = cfg.n_experts
    cap = _capacity(n, cfg)
    xf = x.reshape(n, d)
    r = route(p, xf, cfg)

    # dispatch: gather token rows into [E, C, d] (row n is zeros)
    if cfg.moe_quant_dispatch:
        # int8 payloads with one bf16 scale per token, as the reference
        # moves them across its expert-parallel boundary
        xq, scale = _int8_rows(xf)
        xq = torch.cat([xq, xq.new_zeros((1, d))])
        sq = torch.cat([scale.to(torch.bfloat16),
                        scale.new_ones((1, 1)).to(torch.bfloat16)])
        ex_in = (xq[r.table].float()
                 * sq[r.table].float()).to(x.dtype)
    else:
        xpad = torch.cat([xf, xf.new_zeros((1, d))])
        ex_in = xpad[r.table]                              # [E, C, d]

    # expert computation: batched matmuls over the experts
    h = F.silu(torch.bmm(ex_in, p.w_gate)) * torch.bmm(ex_in, p.w_up)
    ex_out = torch.bmm(h, p.w_down)                        # [E, C, d]

    # combine: weight by the gates, scatter-add back to the tokens
    if cfg.moe_quant_dispatch:
        oq, s_out = _int8_rows(ex_out)
        vals = oq.reshape(-1, d).float() * s_out.reshape(-1, 1)
    else:
        vals = ex_out.reshape(-1, d).float()
    weighted = vals * _slot_gate(r.gate_vals, r.keep, r.slot, e,
                                 cap)[:, None]
    flat_out = torch.zeros((n + 1, d), dtype=torch.float32,
                           device=x.device)
    flat_out.index_add_(0, r.table.reshape(-1), weighted)
    out = flat_out[:n].reshape(b, t, d)

    # aux losses
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.expert_ids[:, 0], e).float().mean(dim=0)
    aux = {
        "load_balance": e * torch.sum(me * ce),
        "router_z": torch.logsumexp(r.logits, dim=-1).square().mean(),
        "dropped_frac": 1.0 - r.keep.float().mean(),
    }
    return out.to(x.dtype), aux
