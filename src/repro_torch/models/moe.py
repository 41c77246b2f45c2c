"""Mixture-of-experts layer with capacity-based sparse dispatch.

The port of ``repro/models/moe.py``.  The dispatch is discrete, so it
follows the reference step for step: float32 router logits and
softmax, the top-k gates renormalised, each (token, k) assignment
ranked within its expert by one stable sort, ``keep = rank < capacity``,
and the kept assignments scattered into an ``[E * C + 1]`` slot table
whose last (sentinel) row takes the dropped ones and is cut off.
Experts then run as dense batched matmuls over ``[E, C, d]``.

Dispatch and combine are a pair of adjoint gathers over the two maps
``route`` builds: ``table`` (the token of each slot, ``n`` if the slot
is empty) and ``slot`` (the slot of each assignment, ``E * C`` if it
was dropped).  Each map indexes a copy of its source with one zero row
appended, so an empty slot or a dropped assignment reads zeros.  The
dispatch gathers token rows by ``table``; its backward gathers the
slots' gradients by ``slot`` and sums each token's ``k`` rows.  The
combine gathers the gate-weighted float32 expert rows by ``slot`` and
sums them; its backward gathers the output's gradient by ``table``.
Each sum over ``k`` runs in float32, in one fixed order, and rounds
once, so results do not vary from run to run; nothing scatters into the
zero row, which would pile every empty slot onto one row.

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


def _pad(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` ``[m, d]`` with one zero row appended."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


def _gather_sum(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[t] = sum_j rows[idx[t, j]]`` for ``idx`` ``[n, k]``, summed
    in float32."""
    g = rows.index_select(0, idx.reshape(-1))
    return g.view(*idx.shape, rows.shape[1]).sum(dim=1, dtype=torch.float32)


class _Dispatch(torch.autograd.Function):
    """``ex_in[s] = x[table[s]]``; backward ``grad_x[t] = sum_k
    grad_ex_in[slot[t, k]]``, rounded once to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, xf, table, slot):
        ctx.save_for_backward(slot)
        d = xf.shape[1]
        return _pad(xf).index_select(0, table.reshape(-1)).view(
            *table.shape, d)

    @staticmethod
    def backward(ctx, grad):
        slot, = ctx.saved_tensors
        g = _pad(grad.reshape(-1, grad.shape[-1]))
        return _gather_sum(g, slot).to(grad.dtype), None, None


class _Combine(torch.autograd.Function):
    """``out[t] = sum_k (gate * vals)[slot[t, k]]`` in float32, for the
    per-slot gate ``sg``; backward ``grad_vals[s] = sg[s] * grad_out[
    table[s]]`` and ``grad_sg[s] = <grad_out[table[s]], vals[s]>``."""

    @staticmethod
    def forward(ctx, vals, sg, slot, table):
        ctx.save_for_backward(vals, sg, table)
        s, d = vals.shape
        rows = vals.new_empty((s + 1, d), dtype=torch.float32)
        torch.mul(vals, sg[:, None], out=rows[:s])
        rows[s].zero_()
        return _gather_sum(rows, slot)

    @staticmethod
    def backward(ctx, grad):
        vals, sg, table = ctx.saved_tensors
        g = _pad(grad.float()).index_select(0, table.reshape(-1))
        grad_vals = grad_sg = None
        if ctx.needs_input_grad[0]:
            grad_vals = torch.mul(g, sg[:, None],
                                  out=torch.empty_like(vals))
        if ctx.needs_input_grad[1]:
            grad_sg = (g * vals).sum(dim=-1)
        return grad_vals, grad_sg, None, None


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

    slot = r.slot.view(n, cfg.top_k)

    # dispatch: gather token rows into [E, C, d] (empty slots read zeros)
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
        ex_in = _Dispatch.apply(xf, r.table, slot)         # [E, C, d]

    # expert computation: batched matmuls over the experts
    h = F.silu(torch.bmm(ex_in, p.w_gate)) * torch.bmm(ex_in, p.w_up)
    ex_out = torch.bmm(h, p.w_down)                        # [E, C, d]

    # combine: gather each token's gate-weighted rows, sum in float32
    if cfg.moe_quant_dispatch:
        oq, s_out = _int8_rows(ex_out)
        vals = oq.reshape(-1, d).float() * s_out.reshape(-1, 1)
    else:
        vals = ex_out.reshape(-1, d)
    sg = _slot_gate(r.gate_vals, r.keep, r.slot, e, cap)
    out = _Combine.apply(vals, sg, slot, r.table).reshape(b, t, d)

    # aux losses
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.expert_ids[:, 0], e).float().mean(dim=0)
    aux = {
        "load_balance": e * torch.sum(me * ce),
        "router_z": torch.logsumexp(r.logits, dim=-1).square().mean(),
        "dropped_frac": 1.0 - r.keep.float().mean(),
    }
    return out.to(x.dtype), aux
