"""Seeded inputs for the select kernels (numpy only).

The CPU tests hold the plain versions in :mod:`repro_torch.kernels.ref`
against the JAX package's Pallas kernels on these inputs, and
``chip_smoke.py`` holds the CUDA kernels against the plain versions on
the same inputs.  Besides random timelines they aim at the seams of a
select kernel that splits the candidates over thread blocks and
combines one row per block:

* :func:`tie_case`: every live candidate has the same ``(key1, key2)``
  under every policy and the smallest start sits only in the last
  block's candidates (or also in an earlier block), so the start and
  index keys decide;
* :func:`infeasible_case`: nothing is feasible and the candidates
  before ``first_live`` are dead, so the lowest live index must win;
* :func:`many_tiles_case`: random starts with dead holes over many
  blocks (and many 128-candidate Pallas tiles).

Each case is a :class:`SelectCase` for one :class:`ResourceSpec`
layout (R = 1 is ``ResourceSpec((n_pe,))``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.resources import ResourceSpec

T_INF = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SelectCase:
    label: str
    times: np.ndarray           # int32[S], sorted, T_INF padding last
    occ: np.ndarray             # uint32[S, W]
    starts: np.ndarray          # int32[P], T_INF = dead
    t_du: int
    t_now: int
    n_req: int
    demand_tail: Tuple[int, ...]  # R - 1 entries


def random_timeline(rng, spec: ResourceSpec, live, capacity: int,
                    fill: float):
    """Sorted, merged records of random reservations, padded to capacity.

    Each reservation takes random live units of every plane (at least
    one of plane 0), so occupancy stays on live units.  Returns ``times
    int32[S]`` and ``occ uint32[S, W]`` satisfying the timeline
    invariants (distinct consecutive rows, empty padding, no bits past a
    plane's units), with about ``fill * capacity`` records.
    """
    valid = spec.valid_bits_np(live)
    planes = []
    for r in range(spec.R):
        o = spec.bit_offset(r)
        planes.append(o + np.nonzero(valid[o:o + 32 * spec.words_per[r]])[0])
    W = spec.total_words
    n_iv = max(1, int(fill * capacity) // 2)
    starts = np.cumsum(rng.integers(0, 40, n_iv))
    ends = starts + rng.integers(1, 400, n_iv)
    bounds = np.unique(np.concatenate([starts, ends]))
    rows = np.zeros((bounds.shape[0], W), np.uint32)
    for s, e in zip(starts, ends):
        bits = np.zeros(W * 32, np.uint8)
        for r, ids in enumerate(planes):
            k = int(rng.integers(1 if r == 0 else 0,
                                 max(2, ids.size // (6 if r == 0 else 3))))
            bits[rng.choice(ids, size=min(k, ids.size), replace=False)] = 1
        mask = np.packbits(bits, bitorder="little").view("<u4")
        rows[np.searchsorted(bounds, s):np.searchsorted(bounds, e)] |= mask
    prev = np.vstack([np.zeros((1, W), np.uint32), rows[:-1]])
    keep = (rows != prev).any(axis=1)
    t, o = bounds[keep], rows[keep]
    if t.shape[0] > capacity:
        raise ValueError(f"random timeline has {t.shape[0]} records > "
                         f"{capacity}")
    times = np.full(capacity, T_INF, np.int32)
    times[:t.shape[0]] = t
    occ = np.zeros((capacity, W), np.uint32)
    occ[:t.shape[0]] = o
    return times, occ


def _live_plane0(spec: ResourceSpec, live) -> int:
    return spec.units[0] if live is None else live[0]


def tie_case(rng, spec: ResourceSpec, live, capacity: int, P: int,
             per_block: int, spread: bool = False) -> SelectCase:
    """All ``P`` candidates live, every window after the last record.

    Their windows overlap only the final (empty) record, so each has
    every live unit free, ``t_begin`` at the last record's end and
    ``t_end = T_INF``: the same ``(key1, key2)`` under every policy.
    The smallest start sits at up to three indices of the last block of
    ``per_block`` candidates, and with ``spread`` also at one index of
    an earlier block, which then wins on the index key.
    """
    times, occ = random_timeline(rng, spec, live, capacity, 0.5)
    t_last = int(times[times < T_INF][-1])
    low = t_last + int(rng.integers(1, 50))
    starts = (low + 1 + rng.integers(0, 100, P)).astype(np.int32)
    last = (P - 1) // per_block * per_block
    idx = rng.choice(np.arange(last, P), size=min(3, P - last),
                     replace=False)
    starts[idx] = low
    if spread and last > 0:
        starts[int(rng.integers(0, last))] = low
    return SelectCase(
        label=f"tie{' spread' if spread else ''} P={P}", times=times,
        occ=occ, starts=starts, t_du=int(rng.integers(1, 400)), t_now=0,
        n_req=1, demand_tail=(0,) * (spec.R - 1))


def infeasible_case(rng, spec: ResourceSpec, live, capacity: int, P: int,
                    first_live: int) -> SelectCase:
    """Nothing feasible; candidates before ``first_live`` dead, the one
    at ``first_live`` live, 30 % dead holes after it.  On R = 1 plane 0
    is one unit short; with R > 1 every plane's demand is one more unit
    than it has."""
    times, occ = random_timeline(rng, spec, live, capacity, 0.5)
    span = int(times[times < T_INF][-1])
    starts = rng.integers(0, span + 1, P).astype(np.int32)
    starts[:first_live] = T_INF
    holes = rng.random(P) < 0.3
    holes[:first_live + 1] = False
    starts[holes] = T_INF
    if spec.R == 1:
        n_req, tail = _live_plane0(spec, live) + 1, ()
    else:
        n_req, tail = 1, tuple(u + 1 for u in spec.units[1:])
    return SelectCase(
        label=f"infeasible P={P} first live {first_live}", times=times,
        occ=occ, starts=starts, t_du=int(rng.integers(1, 400)), t_now=0,
        n_req=n_req, demand_tail=tail)


def many_tiles_case(rng, spec: ResourceSpec, live, capacity: int,
                    P: int) -> SelectCase:
    """Random starts over the timeline's span, 30 % dead holes (index 0
    live), a request a fraction of the machine."""
    times, occ = random_timeline(rng, spec, live, capacity, 0.5)
    span = int(times[times < T_INF][-1])
    starts = rng.integers(0, span + 1, P).astype(np.int32)
    holes = rng.random(P) < 0.3
    holes[0] = False
    starts[holes] = T_INF
    n0 = _live_plane0(spec, live)
    return SelectCase(
        label=f"many tiles P={P}", times=times, occ=occ, starts=starts,
        t_du=int(rng.integers(1, 400)),
        t_now=int(rng.integers(0, max(1, span // 4))),
        n_req=int(rng.integers(1, max(2, n0 // 4))),
        demand_tail=tuple(int(rng.integers(0, u // 2 + 1))
                          for u in spec.units[1:]))


def seam_sizes(per_block: int, multiples: Sequence[int]) -> List[int]:
    """Candidate counts at ``k * per_block`` and one either side."""
    out: List[int] = []
    for k in multiples:
        out += [n for n in (k * per_block - 1, k * per_block,
                            k * per_block + 1) if n >= 1]
    return out


def seam_cases(rng, spec: ResourceSpec, live, capacity: int,
               sizes: Sequence[int], per_block: int,
               first_live: Optional[int] = None) -> List[SelectCase]:
    """Every kind of case at every candidate count in ``sizes``;
    ``first_live`` defaults to the start of the last block."""
    cases: List[SelectCase] = []
    for P in sizes:
        fl = (P - 1) // per_block * per_block if first_live is None \
            else min(first_live, P - 1)
        cases += [tie_case(rng, spec, live, capacity, P, per_block),
                  tie_case(rng, spec, live, capacity, P, per_block,
                           spread=True),
                  infeasible_case(rng, spec, live, capacity, P, fl),
                  many_tiles_case(rng, spec, live, capacity, P)]
    return cases
