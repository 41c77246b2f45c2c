"""Launch wrappers of the CUDA availability-scan kernels.

Each wrapper checks its operands, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its
entry in :data:`LAUNCHES`.  Anything the kernels do not take (a tensor
off the card, another dtype, a non-contiguous tensor, ``n_pe`` outside
``[1, 2048]``) raises; no wrapper falls back to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import T_INF
from repro_torch.core.words import n_words
from repro_torch.kernels import build

# launches per wrapper since the last reset_launches()
LAUNCHES = {"availscan": 0, "availscan_select": 0}

# the policies' exact integer keys need n_free < 2**11
MAX_PE = 2048
N_POLICIES = 7


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(times: torch.Tensor, occ: torch.Tensor, starts: torch.Tensor,
           n_pe: int, t_du: int, t_now: int) -> Tuple[int, int, int]:
    for name, x in (("times", times), ("occ", occ), ("starts", starts)):
        if x.device.type != "cuda":
            raise ValueError(
                f"{name} is on {x.device}; the CUDA kernel takes CUDA "
                f"tensors (CPU tensors go to kernels.ref via kernels.ops)")
        if x.device != times.device:
            raise ValueError(f"{name} is on {x.device}, times on "
                             f"{times.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if times.dim() != 1 or occ.dim() != 2 or starts.dim() != 1:
        raise ValueError(
            f"expected times[S], occ[S, W], starts[P]; got "
            f"{tuple(times.shape)}, {tuple(occ.shape)}, "
            f"{tuple(starts.shape)}")
    S, W = occ.shape
    P = starts.shape[0]
    if times.shape[0] != S or S < 1 or P < 1:
        raise ValueError(f"need S >= 1 records and P >= 1 candidates; "
                         f"got times[{times.shape[0]}], occ[{S}, {W}], "
                         f"starts[{P}]")
    if not 1 <= n_pe <= MAX_PE:
        raise ValueError(f"n_pe={n_pe} outside the kernel's [1, {MAX_PE}]")
    if W != n_words(n_pe):
        raise ValueError(f"occ has {W} words, n_pe={n_pe} needs "
                         f"{n_words(n_pe)}")
    if not 1 <= t_du < T_INF or not -T_INF <= t_now <= T_INF:
        raise ValueError(f"t_du={t_du} / t_now={t_now} out of int32 range")
    return S, W, P


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = lib.availscan_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def availscan(times: torch.Tensor, occ: torch.Tensor, starts: torch.Tensor,
              t_du: int, t_now: int, n_pe: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-candidate ``(n_free, t_begin, t_end)`` on the card.

    Same function as :func:`repro_torch.kernels.ref.availscan_ref`.
    """
    S, W, P = _check(times, occ, starts, n_pe, t_du, t_now)
    out = torch.empty((3, P), dtype=torch.int32, device=times.device)
    lib = build.load()
    with torch.cuda.device(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_rects(
            times.data_ptr(), occ.data_ptr(), starts.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            S, W, P, int(t_du), int(t_now), int(n_pe), stream)
    _raise_on(rc, lib, "availscan")
    LAUNCHES["availscan"] += 1
    return out[0], out[1], out[2]


def availscan_select(times: torch.Tensor, occ: torch.Tensor,
                     starts: torch.Tensor, t_du: int, t_now: int,
                     n_req: int, policy_id: int, n_pe: int) -> torch.Tensor:
    """Fused scan + policy selection on the card: int32[8] row.

    Same function as :func:`repro_torch.kernels.ref.availscan_select_ref`.
    """
    S, W, P = _check(times, occ, starts, n_pe, t_du, t_now)
    if not 0 <= policy_id < N_POLICIES:
        raise ValueError(f"policy id {policy_id} not in [0, {N_POLICIES})")
    if not -T_INF <= n_req <= T_INF:
        raise ValueError(f"n_req={n_req} out of int32 range")
    lib = build.load()
    per_block = lib.availscan_candidates_per_block()
    n_blocks = -(-P // per_block)
    partial = torch.empty((n_blocks, 8), dtype=torch.int32,
                          device=times.device)
    out = torch.empty((8,), dtype=torch.int32, device=times.device)
    with torch.cuda.device(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_select(
            times.data_ptr(), occ.data_ptr(), starts.data_ptr(),
            partial.data_ptr(), out.data_ptr(), S, W, P, int(t_du),
            int(t_now), int(n_req), int(policy_id), int(n_pe), stream)
    _raise_on(rc, lib, "availscan_select")
    LAUNCHES["availscan_select"] += 1
    return out
