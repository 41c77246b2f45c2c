"""Timeline-level entry points of the availability-scan kernels.

A tensor on the CPU goes to the plain version in
:mod:`repro_torch.kernels.ref`; any other tensor goes to the CUDA
kernel in :mod:`repro_torch.kernels.availscan`, which launches or
raises.  The CUDA kernels take any capacity ``S`` (they stream the
records), so no shape limit sends a card tensor to the plain version.

Scalars (``t_du``, ``t_now``, ``n_req``, ``policy_id``) are host
integers: they are kernel arguments, and reading them from the card
would stall the host.  ``rspec`` selects the multi-resource kernels;
their layout (per-word plane ids, the default valid mask) is copied to
the device once per spec, and the demand tail stays a device tensor.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import resources as res_lib
from repro_torch.core import search as search_lib
from repro_torch.core.timeline import Timeline
from repro_torch.core.types import T_INF
from repro_torch.kernels import availscan as _k
from repro_torch.kernels import ref as _ref


def availability_rectangles(tl: Timeline, starts: torch.Tensor, t_du: int,
                            t_now: int, n_pe: int, *, rspec=None,
                            valid_mask: Optional[torch.Tensor] = None
                            ) -> search_lib.Rectangles:
    """Kernel-backed :func:`repro_torch.core.search.availability_rectangles`."""
    if rspec is not None:
        lay = res_lib.device_layout(rspec, tl.device)
        args = (tl.times, tl.occ, starts,
                lay.valid_mask if valid_mask is None else valid_mask,
                lay.plane_of_word, rspec.R, int(t_du), int(t_now))
        if starts.device.type == "cpu":
            n_free, tail, t_begin, t_end = _ref.availscan_mr_ref(*args)
        else:
            n_free, tail, t_begin, t_end = _k.availscan_mr(
                *args, n_pe=rspec.n_pe)
        return search_lib.Rectangles(
            starts=starts, n_free=n_free, t_begin=t_begin, t_end=t_end,
            valid=starts < T_INF, n_free_tail=tail)
    if starts.device.type == "cpu":
        n_free, t_begin, t_end = _ref.availscan_ref(
            tl.times, tl.occ, starts, int(t_du), int(t_now), n_pe)
    else:
        n_free, t_begin, t_end = _k.availscan(
            tl.times, tl.occ, starts, int(t_du), int(t_now), n_pe)
    return search_lib.Rectangles(starts=starts, n_free=n_free,
                                 t_begin=t_begin, t_end=t_end,
                                 valid=starts < T_INF)


def window_rectangle(tl: Timeline, s: int, t_du: int, t_now: int,
                     n_pe: int, *, rspec=None,
                     valid_mask: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """The early reject's rectangle: one window at start ``s`` (a host
    integer), one kernel launch on the card.

    Returns ``n_free``, ``t_begin``, ``t_end``, ``n_free_tail`` (int32[R
    - 1], empty without ``rspec``) and the rejected search result's
    ``t_s`` (= ``s``), ``t_e`` (``s + t_du``), ``found`` (False) and
    ``pe_mask`` (int32[W] zeros), all views of the kernel's one int32
    row (:func:`repro_torch.kernels.availscan.availscan_one`), so
    nothing else runs on the card.
    """
    if rspec is not None:
        lay = res_lib.device_layout(rspec, tl.device)
        args = (tl.times, tl.occ, int(s),
                lay.valid_mask if valid_mask is None else valid_mask,
                lay.plane_of_word, rspec.R, int(t_du), int(t_now))
        if tl.times.device.type == "cpu":
            row = _ref.availscan_one_mr_ref(*args)
        else:
            row = _k.availscan_one_mr(*args, n_pe=rspec.n_pe)
        R = rspec.R
    else:
        args = (tl.times, tl.occ, int(s), int(t_du), int(t_now), n_pe)
        if tl.times.device.type == "cpu":
            row = _ref.availscan_one_ref(*args)
        else:
            row = _k.availscan_one(*args)
        R = 1
    return dict(n_free=row[0], t_begin=row[1], t_end=row[2],
                n_free_tail=row[3:R + 2], t_s=row[R + 2], t_e=row[R + 3],
                # a bool view of the int32 0's first byte: no conversion
                # kernel
                found=row[R + 4:R + 5].view(torch.bool)[0],
                pe_mask=row[R + 5:])


def search_select(tl: Timeline, starts: torch.Tensor, t_du: int,
                  t_now: int, n_req: int, policy_id: int,
                  n_pe: int, *, rspec=None,
                  demand_tail: Optional[torch.Tensor] = None,
                  valid_mask: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Fused scan + policy selection: the winning candidate.

    Returns ``found``, ``best`` (index into ``starts``) and the
    winner's ``n_free`` / ``t_begin`` / ``t_end``, all 0-d tensors on
    the timeline's device, identical to
    :func:`availability_rectangles` followed by ``policies.select``
    on compacted candidates.  With ``rspec`` the vector fit takes
    ``demand_tail`` (int32[R-1], default zeros) and ``valid_mask``.
    """
    if rspec is not None:
        lay = res_lib.device_layout(rspec, tl.device)
        args = (tl.times, tl.occ, starts,
                lay.valid_mask if valid_mask is None else valid_mask,
                lay.plane_of_word,
                lay.zero_tail if demand_tail is None else demand_tail,
                int(t_du), int(t_now), int(n_req), int(policy_id))
        if starts.device.type == "cpu":
            row = _ref.availscan_select_mr_ref(*args)
        else:
            row = _k.availscan_select_mr(*args, n_pe=rspec.n_pe)
    elif starts.device.type == "cpu":
        row = _ref.availscan_select_ref(
            tl.times, tl.occ, starts, int(t_du), int(t_now), int(n_req),
            int(policy_id), n_pe)
    else:
        row = _k.availscan_select(
            tl.times, tl.occ, starts, int(t_du), int(t_now), int(n_req),
            int(policy_id), n_pe)
    return dict(found=row[7] > 0, best=row[3], n_free=row[4],
                t_begin=row[5], t_end=row[6])
