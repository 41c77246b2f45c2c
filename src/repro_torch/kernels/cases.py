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
  blocks (and many 128-candidate Pallas tiles);
* :func:`pruned_cases`: the candidate arrays the availability index's
  pruning hands the kernels (dead holes in the middle, index 0 always
  live), and the one-candidate arrays of the early reject;
* :func:`no_blocking_timeline`: a timeline on which nothing blocks a
  window, so the rectangle kernels' outward scans run to both ends.

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


#: 128-candidate tiles of the reference's Pallas kernels
PALLAS_TILE = 128


def _feasible_request(rng, spec: ResourceSpec, live):
    """A request of a fraction of the machine on every plane."""
    n0 = _live_plane0(spec, live)
    return (int(rng.integers(1, max(2, n0 // 3))),
            tuple(int(rng.integers(0, u // 3 + 1)) for u in spec.units[1:]))


def pruned_cases(rng, spec: ResourceSpec, live, capacity: int
                 ) -> List[SelectCase]:
    """Candidate arrays with the holes that index pruning leaves.

    Sorted distinct starts over the timeline's span, ``P = 2S + 2``
    (the search's shape), then masked to ``T_INF`` the way
    ``search.prune_candidates`` masks them, index 0 always live:

    * ``holes``: 40 % dead in the middle of the array;
    * ``seam``: indices 1 .. 127 dead, so the first live one after
      index 0 opens the second 128-candidate tile (P >= 129);
    * ``only 0``: every candidate but index 0 dead, once with a request
      index 0 can hold and once with one it cannot;
    * ``one``: a single candidate (``P = 1``), the early reject's
      rectangle query, feasible and not.
    """
    times, occ = random_timeline(rng, spec, live, capacity, 0.5)
    span = int(times[times < T_INF][-1])
    P = 2 * capacity + 2
    t_du = int(rng.integers(1, 400))
    n_req, tail = _feasible_request(rng, spec, live)
    n0 = _live_plane0(spec, live)
    out: List[SelectCase] = []

    def case(label, starts, n_req=n_req, tail=tail):
        out.append(SelectCase(
            label=f"pruned {label} P={starts.shape[0]}", times=times,
            occ=occ, starts=starts.astype(np.int32), t_du=t_du,
            t_now=int(rng.integers(0, max(1, span // 4))), n_req=n_req,
            demand_tail=tail))

    base = np.sort(rng.choice(span + 1, size=min(P, span + 1),
                              replace=False))
    base = np.concatenate([base, np.full(P - base.shape[0], T_INF)])
    holes = base.copy()
    dead = rng.random(P) < 0.4
    dead[0] = False
    holes[dead] = T_INF
    case("holes", holes)
    if P > PALLAS_TILE:
        seam = base.copy()
        seam[1:PALLAS_TILE] = T_INF
        case("seam", seam)
    only0 = np.full(P, T_INF)
    only0[0] = base[0]
    case("only 0", only0)
    case("only 0 infeasible", only0, n_req=n0 + 1)
    one = base[:1].copy()
    case("one", one)
    case("one infeasible", one, n_req=n0 + 1)
    return out


def no_blocking_timeline(spec: ResourceSpec, capacity: int, n_records: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``n_records`` records two time units apart, the even ones holding
    units 0-9 of plane 0, the odd ones empty, padded to ``capacity``.  A
    window over an even record makes those units busy, and every other
    record occupies only them, so no record blocks it on either side:
    the scans test every record (the one-window kernel's far bands, over
    several rounds when a side holds more than a few hundred records)."""
    times = np.full(capacity, T_INF, np.int32)
    times[:n_records] = np.arange(0, 2 * n_records, 2)
    occ = np.zeros((capacity, spec.total_words), np.uint32)
    occ[0:n_records:2, 0] = 0x3FF
    return times, occ
