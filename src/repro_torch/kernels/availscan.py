"""Launch wrappers of the CUDA availability-scan kernels.

Each wrapper checks its operands, allocates its output with
``torch.empty`` (one buffer a call), launches on PyTorch's current
stream without synchronising, raises if the launch was refused, and
adds one to its entry in :data:`LAUNCHES`.  Anything the kernels do not
take (a tensor off the card, another dtype, a non-contiguous tensor,
``n_pe`` outside ``[1, 2048]``, a multi-resource layout wider than 512
words, a scalar outside int32) raises; no wrapper falls back to the
plain version.

The select wrappers replace the TPU kernels ``availscan_select`` and
``availscan_select_mr`` (``src/repro/kernels/availscan.py`` l.373 and
l.494).  A call costs launch latency, not bytes, so each is one launch
with nothing allocated but its int32[8] result: the blocks combine their
rows through a ticket counter in a scratch buffer allocated once per
device and stream (:func:`_select_scratch`), which the kernel leaves at
0 for the next call.  The wrappers enter ``torch.cuda.device`` only when
the tensors are not on the current device.

The rectangle wrappers replace ``availscan`` and ``availscan_mr``
(l.146 and l.228), each in two modes, one entry each.
:func:`availscan` and :func:`availscan_mr` take a starts tensor of any
length ``P`` and run the select kernels' device body in rectangle mode;
their results are views of one int32 buffer.  :func:`availscan_one` and
:func:`availscan_one_mr` are the early reject's entry, the one-window
kernel (the whole block on one candidate): the start is a host integer
(a kernel argument, so no starts tensor is made), and the one launch
writes one int32 row, the rejected search result's fields,
of which the search takes views: ``n_free, t_begin, t_end``, the other
planes' counts on ``_mr`` (R - 1), ``t_s, t_e, found`` (0), then ``W``
words of PE mask (0).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.types import T_INF
from repro_torch.core.words import n_words
from repro_torch.kernels import build

# launches per wrapper since the last reset_launches()
LAUNCHES = {"availscan": 0, "availscan_select": 0, "availscan_mr": 0,
            "availscan_select_mr": 0}

# the policies' exact integer keys need n_free < 2**11 (plane 0's units
# on multi-resource layouts)
MAX_PE = 2048
N_POLICIES = 7
# multi-resource occupancy words the _mr kernels take (16 per lane)
MAX_WORDS_MR = 512


# the select kernels' scratch (ticket counter + block rows), one per
# (device index, stream handle): two streams never share a counter
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on(device: torch.device):
    """``torch.cuda.device(device)`` unless it is the current device."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _select_scratch(lib, device: torch.device, stream: int) -> torch.Tensor:
    """The select kernels' scratch for this device and stream, zeroed
    once and sized for the largest grid they launch; the kernel resets
    its counter to 0 at the end of every call."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = torch.zeros(lib.availscan_select_scratch_ints(),
                          dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def _check_tensors(times: torch.Tensor, **named: torch.Tensor) -> None:
    for name, x in (("times", times), *named.items()):
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


def _check_scalars(n_pe: int, t_du: int, t_now: int) -> None:
    if not 1 <= n_pe <= MAX_PE:
        raise ValueError(f"n_pe={n_pe} outside the kernel's [1, {MAX_PE}]")
    if not 1 <= t_du < T_INF or not -T_INF <= t_now <= T_INF:
        raise ValueError(f"t_du={t_du} / t_now={t_now} out of int32 range")


def _check(times: torch.Tensor, occ: torch.Tensor,
           starts: Optional[torch.Tensor], n_pe: int, t_du: int, t_now: int,
           n_words_of=n_words) -> Tuple[int, int, int]:
    """Scalars, then tensors and shapes, every wrapper's; ``(S, W, P)``.

    ``starts`` is ``None`` for the one-window entries (``P = 1``);
    ``n_words_of(n_pe)`` is the word width ``occ`` must have (``None``
    to take any).
    """
    _check_scalars(n_pe, t_du, t_now)
    _check_tensors(times, occ=occ,
                   **({} if starts is None else {"starts": starts}))
    if times.dim() != 1 or occ.dim() != 2 or (
            starts is not None and starts.dim() != 1):
        raise ValueError(
            f"expected times[S], occ[S, W], starts[P]; got "
            f"{tuple(times.shape)}, {tuple(occ.shape)}, "
            f"{None if starts is None else tuple(starts.shape)}")
    S, W = occ.shape
    P = 1 if starts is None else starts.shape[0]
    if times.shape[0] != S or S < 1 or P < 1:
        raise ValueError(f"need S >= 1 records and P >= 1 candidates; "
                         f"got times[{times.shape[0]}], occ[{S}, {W}], "
                         f"starts[{P}]")
    if n_words_of is not None and W != n_words_of(n_pe):
        raise ValueError(f"occ has {W} words, n_pe={n_pe} needs "
                         f"{n_words_of(n_pe)}")
    return S, W, P


def _check_start(s: int) -> None:
    if not -T_INF - 1 <= s <= T_INF:
        raise ValueError(f"start {s} out of int32 range")


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = lib.availscan_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def availscan(times: torch.Tensor, occ: torch.Tensor, starts: torch.Tensor,
              t_du: int, t_now: int, n_pe: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-candidate ``(n_free, t_begin, t_end)`` on the card.

    Same function as :func:`repro_torch.kernels.ref.availscan_ref`; the
    three are rows of one int32[3, P] buffer.
    """
    S, W, P = _check(times, occ, starts, n_pe, t_du, t_now)
    out = torch.empty((3, P), dtype=torch.int32, device=times.device)
    lib = build.load()
    with _on(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_rects(
            times.data_ptr(), occ.data_ptr(), starts.data_ptr(),
            out.data_ptr(), S, W, P, int(t_du), int(t_now), int(n_pe),
            stream)
    _raise_on(rc, lib, "availscan")
    LAUNCHES["availscan"] += 1
    return out[0], out[1], out[2]


def availscan_one(times: torch.Tensor, occ: torch.Tensor, s: int,
                  t_du: int, t_now: int, n_pe: int) -> torch.Tensor:
    """The rectangle of one window at start ``s`` on the card, with the
    rejected search result around it: int32[6 + W], ``n_free, t_begin,
    t_end, t_s, t_e, found`` then ``W`` words of PE mask (``found`` and
    the mask 0).  One launch, counted as ``availscan``.

    Same function as :func:`repro_torch.kernels.ref.availscan_one_ref`.
    """
    _check_start(s)
    S, W, _ = _check(times, occ, None, n_pe, t_du, t_now)
    out = torch.empty((6 + W,), dtype=torch.int32, device=times.device)
    lib = build.load()
    with _on(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_one(
            times.data_ptr(), occ.data_ptr(), int(s), out.data_ptr(), S, W,
            int(t_du), int(t_now), int(n_pe), stream)
    _raise_on(rc, lib, "availscan")
    LAUNCHES["availscan"] += 1
    return out


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
    out = torch.empty((8,), dtype=torch.int32, device=times.device)
    with _on(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_select(
            times.data_ptr(), occ.data_ptr(), starts.data_ptr(),
            _select_scratch(lib, times.device, stream).data_ptr(),
            out.data_ptr(), S, W, P, int(t_du), int(t_now), int(n_req),
            int(policy_id), int(n_pe), stream)
    _raise_on(rc, lib, "availscan_select")
    LAUNCHES["availscan_select"] += 1
    return out


def _check_mr(times, occ, starts, valid_mask, plane_of_word, n_planes,
              n_pe, t_du, t_now) -> Tuple[int, int, int]:
    S, W, P = _check(times, occ, starts, n_pe, t_du, t_now,
                     n_words_of=None)
    _check_tensors(times, valid_mask=valid_mask, plane_of_word=plane_of_word)
    if not 1 <= W <= MAX_WORDS_MR:
        raise ValueError(f"occ has {W} words; the multi-resource kernels "
                         f"take 1 to {MAX_WORDS_MR}")
    if valid_mask.shape != (W,) or plane_of_word.shape != (W,):
        raise ValueError(
            f"valid_mask and plane_of_word must be [{W}]; got "
            f"{tuple(valid_mask.shape)}, {tuple(plane_of_word.shape)}")
    if not 1 <= n_planes <= W:
        raise ValueError(f"{n_planes} planes on {W} words")
    if n_words(n_pe) > W:
        raise ValueError(f"plane 0 of {n_pe} units needs {n_words(n_pe)} "
                         f"words, occ has {W}")
    return S, W, P


def availscan_mr(times: torch.Tensor, occ: torch.Tensor,
                 starts: torch.Tensor, valid_mask: torch.Tensor,
                 plane_of_word: torch.Tensor, n_planes: int, t_du: int,
                 t_now: int, *, n_pe: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Multi-resource rectangles on the card.

    ``(n_free[P], n_free_tail[P, R-1], t_begin[P], t_end[P])``, the same
    function as :func:`repro_torch.kernels.ref.availscan_mr_ref`, all
    views of one int32 buffer (``[3, P]`` then ``[P, R-1]``).  ``n_pe``
    (plane 0's units) is checked against the keys' range.
    """
    S, W, P = _check_mr(times, occ, starts, valid_mask, plane_of_word,
                        n_planes, n_pe, t_du, t_now)
    out = torch.empty((P * (n_planes + 2),), dtype=torch.int32,
                      device=times.device)
    lib = build.load()
    with _on(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_rects_mr(
            times.data_ptr(), occ.data_ptr(), valid_mask.data_ptr(),
            plane_of_word.data_ptr(), starts.data_ptr(), out.data_ptr(), S,
            W, int(n_planes), P, int(t_du), int(t_now), stream)
    _raise_on(rc, lib, "availscan_mr")
    LAUNCHES["availscan_mr"] += 1
    head = out[:3 * P].view(3, P)
    return head[0], out[3 * P:].view(P, n_planes - 1), head[1], head[2]


def availscan_one_mr(times: torch.Tensor, occ: torch.Tensor, s: int,
                     valid_mask: torch.Tensor, plane_of_word: torch.Tensor,
                     n_planes: int, t_du: int, t_now: int, *, n_pe: int
                     ) -> torch.Tensor:
    """Multi-resource :func:`availscan_one`: int32[R + 5 + W], as its
    row with the other planes' counts (R - 1) after ``t_end``.  One
    launch, counted as ``availscan_mr``.

    Same function as :func:`repro_torch.kernels.ref.availscan_one_mr_ref`.
    """
    _check_start(s)
    S, W, _ = _check_mr(times, occ, None, valid_mask, plane_of_word,
                        n_planes, n_pe, t_du, t_now)
    out = torch.empty((n_planes + 5 + W,), dtype=torch.int32,
                      device=times.device)
    lib = build.load()
    with _on(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_one_mr(
            times.data_ptr(), occ.data_ptr(), valid_mask.data_ptr(),
            plane_of_word.data_ptr(), int(s), out.data_ptr(), S, W,
            int(n_planes), int(t_du), int(t_now), stream)
    _raise_on(rc, lib, "availscan_mr")
    LAUNCHES["availscan_mr"] += 1
    return out


def availscan_select_mr(times: torch.Tensor, occ: torch.Tensor,
                        starts: torch.Tensor, valid_mask: torch.Tensor,
                        plane_of_word: torch.Tensor,
                        demand_tail: torch.Tensor, t_du: int, t_now: int,
                        n_req: int, policy_id: int, *, n_pe: int
                        ) -> torch.Tensor:
    """Multi-resource fused scan + selection on the card: int32[8] row.

    Same function as
    :func:`repro_torch.kernels.ref.availscan_select_mr_ref`; the demand
    tail (int32[R-1]) is read on the card, never by the host.
    """
    n_planes = demand_tail.shape[0] + 1 if demand_tail.dim() == 1 else -1
    S, W, P = _check_mr(times, occ, starts, valid_mask, plane_of_word,
                        n_planes, n_pe, t_du, t_now)
    _check_tensors(times, demand_tail=demand_tail)
    if not 0 <= policy_id < N_POLICIES:
        raise ValueError(f"policy id {policy_id} not in [0, {N_POLICIES})")
    if not -T_INF <= n_req <= T_INF:
        raise ValueError(f"n_req={n_req} out of int32 range")
    lib = build.load()
    out = torch.empty((8,), dtype=torch.int32, device=times.device)
    with _on(times.device):
        stream = torch.cuda.current_stream(times.device).cuda_stream
        rc = lib.availscan_select_mr(
            times.data_ptr(), occ.data_ptr(), valid_mask.data_ptr(),
            plane_of_word.data_ptr(), demand_tail.data_ptr(),
            starts.data_ptr(),
            _select_scratch(lib, times.device, stream).data_ptr(),
            out.data_ptr(), S, W, n_planes, P, int(t_du), int(t_now),
            int(n_req), int(policy_id), stream)
    _raise_on(rc, lib, "availscan_select_mr")
    LAUNCHES["availscan_select_mr"] += 1
    return out
