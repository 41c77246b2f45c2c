"""Hierarchical availability index: per-tile timeline summaries.

The ``S`` timeline records are grouped into ``NT = S / T`` tiles of
``T`` consecutive records, and three small summary tensors ride next
to the timeline:

``idx_occ : int32[NT, W]``
    bitwise OR of the tile's occupancy rows (uint32 bits in int32, as
    the timeline's words): every unit busy somewhere in the tile.
``idx_minfree : int32[NT, R]``
    ``units[r]`` minus the plane-``r`` popcount of ``idx_occ[k]``: an
    upper bound on the free units of any window that fully contains
    tile ``k`` (its busy union covers the tile's OR).
``idx_maxfree : int32[NT, R]``
    the most free units of any one row of the tile: an upper bound on
    the free units of any window that covers at least one of its rows.

Both bounds only ever prove infeasibility that the exact search would
also find, so the consumers in :mod:`repro_torch.core.search`
(candidate pruning, the early reject) keep decisions identical.
Padding rows (``times == T_INF``, no bits) contribute nothing to
``idx_occ`` and a full-free row to ``idx_maxfree``, which is what the
all-free region they stand for means.

The port's copy of ``repro/core/availindex.py``.  Torch has no
bitwise-OR reduction, so ``idx_occ`` folds the tile axis in
``log2(T)`` halvings (``T`` is a power of two); bits are counted with
the SWAR popcount of :mod:`repro_torch.core.words`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import words as words_lib
from repro_torch.core.words import n_words

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Static layout of the index: records per tile (a power of two, so
    every grown power-of-two capacity stays divisible), and per plane
    its unit count and packed word width.  Frozen and hashable."""

    tile: int
    units: Tuple[int, ...]
    words_per: Tuple[int, ...]

    def __post_init__(self) -> None:
        tile = int(self.tile)
        if tile < 1 or (tile & (tile - 1)) != 0:
            raise ValueError(
                f"index tile must be a positive power of two: {tile}")
        units = tuple(int(u) for u in self.units)
        words = tuple(int(w) for w in self.words_per)
        if not units or len(units) != len(words):
            raise ValueError(f"units/words_per mismatch: {units} vs {words}")
        object.__setattr__(self, "tile", tile)
        object.__setattr__(self, "units", units)
        object.__setattr__(self, "words_per", words)

    @property
    def R(self) -> int:
        return len(self.units)

    @property
    def total_words(self) -> int:
        return sum(self.words_per)

    @property
    def word_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for w in self.words_per:
            offs.append(acc)
            acc += w
        return tuple(offs)

    def plane_slice(self, r: int) -> slice:
        off = self.word_offsets[r]
        return slice(off, off + self.words_per[r])

    def n_tiles(self, capacity: int) -> int:
        if capacity % self.tile != 0:
            raise ValueError(
                f"capacity {capacity} not divisible by tile {self.tile}")
        return capacity // self.tile


def make_index_spec(tile: int, n_pe: int, rspec=None) -> IndexSpec:
    """The spec of a single-resource (``rspec=None``) or vector layout."""
    if rspec is None:
        return IndexSpec(tile=tile, units=(int(n_pe),),
                         words_per=(n_words(int(n_pe)),))
    return IndexSpec(tile=tile, units=tuple(rspec.units),
                     words_per=tuple(rspec.words_per))


@functools.lru_cache(maxsize=None)
def units_on(ispec: IndexSpec, device: torch.device) -> torch.Tensor:
    """int32[R] unit counts on ``device``, copied there once."""
    return torch.tensor(ispec.units, dtype=I32).to(device)


def plane_counts(words: torch.Tensor, ispec: IndexSpec) -> torch.Tensor:
    """Per-plane popcount of packed rows: ``[..., W] -> int32[..., R]``."""
    c = words_lib.popcount(words)
    if ispec.R == 1:
        return c.sum(dim=-1, keepdim=True, dtype=I32)
    return torch.stack([c[..., ispec.plane_slice(r)].sum(dim=-1, dtype=I32)
                        for r in range(ispec.R)], dim=-1)


def build_summaries(times: torch.Tensor, occ: torch.Tensor,
                    ispec: IndexSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical summaries ``(idx_occ, idx_minfree, idx_maxfree)`` of
    the rows; every timeline update refreshes the index with this."""
    S, W = occ.shape
    T = ispec.tile
    NT = ispec.n_tiles(S)
    units = units_on(ispec, occ.device)
    idx_occ = words_lib.or_reduce(occ.reshape(NT, T, W), dim=1)   # [NT, W]
    idx_minfree = units[None, :] - plane_counts(idx_occ, ispec)
    row_free = units[None, :] - plane_counts(occ, ispec)          # [S, R]
    idx_maxfree = row_free.reshape(NT, T, ispec.R).amax(dim=1)
    return idx_occ, idx_minfree, idx_maxfree


def empty_summaries(capacity: int, ispec: IndexSpec, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Summaries of an all-free timeline (every row is padding)."""
    NT = ispec.n_tiles(capacity)
    units = units_on(ispec, device)
    full = units[None, :].expand(NT, ispec.R)
    return (torch.zeros((NT, ispec.total_words), dtype=I32, device=device),
            full.clone(), full.clone())


def plane_deficit(ispec: IndexSpec,
                  valid_mask: Optional[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """int32[R]: nominal units minus this lane's schedulable units.

    Summaries count free units against the nominal ``units[r]``; the
    search counts them against the lane's ``valid_mask``.  Occupancy
    never leaves the valid mask, so the two differ by this constant per
    plane, and the bounds subtract it.
    """
    units = units_on(ispec, device)
    if valid_mask is None:
        return torch.zeros_like(units)
    return units - plane_counts(valid_mask, ispec)
