"""Static multi-resource layout descriptor.

The availability timeline generalises from one packed PE bitmask per
record to one packed bitplane per resource, concatenated along the
occupancy word axis.  Plane ``r`` covers ``units[r]`` schedulable units
and occupies the word range ``[word_offsets[r], word_offsets[r] +
words_per[r])``; resource 0 is always the paper's PE plane.  With
``R == 1`` the layout is the single-resource timeline's, word for word.

The port's own copy of ``repro/core/resources.py``: a plain frozen
dataclass (hashable, so it can key caches), and the device copies of
the layout that the multi-resource kernels read, made once per
``(spec, device)`` by :func:`device_layout`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.words import WORD, n_words, to_int32


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """Per-resource unit counts; ``units[0]`` is the primary PE plane."""

    units: Tuple[int, ...]

    def __post_init__(self) -> None:
        units = tuple(int(u) for u in self.units)
        if not units:
            raise ValueError("ResourceSpec needs at least one resource")
        if any(u <= 0 for u in units):
            raise ValueError(f"resource units must be positive: {units}")
        object.__setattr__(self, "units", units)

    @property
    def R(self) -> int:
        return len(self.units)

    @property
    def n_pe(self) -> int:
        return self.units[0]

    @property
    def words_per(self) -> Tuple[int, ...]:
        return tuple(n_words(u) for u in self.units)

    @property
    def word_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for w in self.words_per:
            offs.append(acc)
            acc += w
        return tuple(offs)

    @property
    def total_words(self) -> int:
        return sum(self.words_per)

    @property
    def total_bits(self) -> int:
        return self.total_words * WORD

    def plane_slice(self, r: int) -> slice:
        """Word-axis slice of plane ``r``."""
        off = self.word_offsets[r]
        return slice(off, off + self.words_per[r])

    def bit_offset(self, r: int) -> int:
        """Global bit id of unit 0 of plane ``r``."""
        return self.word_offsets[r] * WORD

    def valid_bits_np(self,
                      live_units: Optional[Sequence[int]] = None
                      ) -> np.ndarray:
        """0/1 uint32[total_bits]: the schedulable units of each plane.

        ``live_units`` optionally shrinks planes for heterogeneous
        machine lanes (``live_units[r] <= units[r]``); padding between
        ``live_units[r]`` and the plane's word boundary stays 0.
        """
        live = self.units if live_units is None else tuple(live_units)
        if len(live) != self.R:
            raise ValueError(
                f"live_units has {len(live)} entries, spec has {self.R}")
        bits = np.zeros(self.total_bits, dtype=np.uint32)
        for r, (u, lu) in enumerate(zip(self.units, live)):
            lu = int(lu)
            if not 0 < lu <= u:
                raise ValueError(f"live_units[{r}]={lu} outside (0, {u}]")
            o = self.bit_offset(r)
            bits[o:o + lu] = 1
        return bits

    def valid_mask_np(self,
                      live_units: Optional[Sequence[int]] = None
                      ) -> np.ndarray:
        """Packed valid-unit mask, int32[total_words] with uint32 bits."""
        b = self.valid_bits_np(live_units).reshape(self.total_words, WORD)
        shifts = np.arange(WORD, dtype=np.uint32)
        return to_int32((b << shifts).sum(axis=1).astype(np.uint32))

    def plane_of_word_np(self) -> np.ndarray:
        """int32[total_words]: the plane each occupancy word belongs to."""
        return np.repeat(np.arange(self.R, dtype=np.int32),
                         self.words_per)

    def demand_tail(self, demand: Optional[Sequence[int]],
                    n_pe: int) -> Tuple[int, ...]:
        """Validate a request's demand vector, return planes 1..R-1.

        ``demand`` is the full per-resource vector; ``None`` means
        "PEs only" (zero demand on every secondary plane).  Plane 0
        must agree with the request's ``n_pe``.
        """
        if demand is None:
            return (0,) * (self.R - 1)
        d = tuple(int(x) for x in demand)
        if len(d) != self.R:
            raise ValueError(
                f"demand has {len(d)} entries, spec has {self.R}")
        if d[0] != int(n_pe):
            raise ValueError(
                f"demand[0]={d[0]} must equal n_pe={int(n_pe)}")
        for r, x in enumerate(d):
            if not 0 <= x <= self.units[r]:
                raise ValueError(
                    f"demand[{r}]={x} outside [0, {self.units[r]}]")
        return d[1:]


class DeviceLayout(NamedTuple):
    """A spec's layout as tensors on one device (read-only, shared)."""

    plane_of_word: torch.Tensor  # int32[W]
    valid_mask: torch.Tensor     # int32[W], every unit live
    plane_of_bit: torch.Tensor   # int64[W * 32]
    plane_start: torch.Tensor    # int64[W * 32]: first bit of its plane
    zero_tail: torch.Tensor      # int32[R - 1]


@functools.lru_cache(maxsize=None)
def device_layout(spec: ResourceSpec, device: torch.device) -> DeviceLayout:
    """The spec's layout on ``device``, copied there once."""
    pw = spec.plane_of_word_np()
    pb = np.repeat(pw, WORD).astype(np.int64)
    starts = np.asarray([spec.bit_offset(r) for r in range(spec.R)],
                        np.int64)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return DeviceLayout(
        plane_of_word=put(pw), valid_mask=put(spec.valid_mask_np()),
        plane_of_bit=put(pb), plane_start=put(starts[pb]),
        zero_tail=torch.zeros((spec.R - 1,), dtype=torch.int32,
                              device=device))
