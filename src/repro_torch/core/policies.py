"""Policy scoring in exact integer arithmetic (Section 5).

Every policy minimises a primary score with an earliest-start
tiebreak.  float32 cannot tell durations near 2**31 apart, so the
``PE x duration`` product (up to ~2**42) is split into two
lexicographically ordered int32 keys.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import ALL_POLICIES, Policy

POLICY_IDS = {p: i for i, p in enumerate(ALL_POLICIES)}
BIG = 2**31 - 1


def policy_index(policy: Policy) -> int:
    return POLICY_IDS[Policy(policy)]


def integer_keys(policy_id: int, n_free: torch.Tensor,
                 duration: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ``(key1, key2)`` minimisation keys for ``policy_id``.

    ``n_free * duration = p_hi * 2**16 + p_lo`` with ``p_lo < 2**16``,
    so ``(p_hi, p_lo)`` orders like the true product while both fit
    int32; this needs ``n_free < 2**11`` (at most 2048 PEs).
    """
    nf = n_free.to(torch.int32)
    du = duration.to(torch.int32)
    du_hi = du >> 16
    du_lo = du & 0xFFFF
    p_lo_raw = nf * du_lo
    p_hi = nf * du_hi + (p_lo_raw >> 16)
    p_lo = p_lo_raw & 0xFFFF
    zero = torch.zeros_like(nf)
    key1 = (zero, nf, -nf, du, -du, p_hi, -p_hi)[policy_id]
    key2 = (zero, zero, zero, zero, zero, p_lo, -p_lo)[policy_id]
    return key1, key2


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry of a 1-D mask (0 if none)."""
    idx = torch.arange(mask.shape[0], device=mask.device)
    first = torch.where(mask, idx, mask.shape[0]).min()
    return torch.where(first < mask.shape[0], first, 0)


def select(policy_id: int, n_free: torch.Tensor, duration: torch.Tensor,
           starts: torch.Tensor, feasible: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the best feasible candidate for ``policy_id``.

    Returns ``(best_index, found)``: the lexicographic
    ``(key1, key2, t_s)`` minimum over feasible candidates, earliest
    index on full ties, as three chained masked minima and a
    first-true pick.
    """
    key1, key2 = integer_keys(policy_id, n_free, duration)
    key1 = torch.where(feasible, key1, BIG)
    key2 = torch.where(feasible, key2, BIG)
    tiebreak = torch.where(feasible, starts, BIG)
    e1 = key1 == key1.min()
    m2 = torch.where(e1, key2, BIG).min()
    e2 = e1 & (key2 == m2)
    m3 = torch.where(e2, tiebreak, BIG).min()
    best = first_true(e2 & (tiebreak == m3))
    return best, feasible.index_select(0, best.reshape(1))[0]
