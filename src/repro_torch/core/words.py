"""Occupancy words as int32 tensors with the bits of a uint32.

The reference timeline stores ``uint32`` words.  PyTorch's ``uint32``
lacks ``~``, ``>>`` and reductions on the CPU, so the port keeps the
same 32 bits in ``int32``: ``np.ndarray.view`` converts either way
without touching a bit.  ``>>`` on int32 sign-extends, so the helpers
that need a logical shift mask after shifting.  Torch has no bitwise
OR reduction; :func:`or_reduce` folds in ``log2(n)`` steps.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32


def n_words(n_pe: int) -> int:
    return (n_pe + WORD - 1) // WORD


def to_int32(words: np.ndarray) -> np.ndarray:
    """uint32 words -> int32 with the same bits (a writable copy)."""
    return np.array(words, dtype=np.uint32).view(np.int32)


def to_uint32(words: np.ndarray) -> np.ndarray:
    """int32 words -> uint32 with the same bits (a writable copy)."""
    return np.array(words, dtype=np.int32).view(np.uint32)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by ``0 <= k < 32``."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (WORD - k)) - 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 words (int32 result).

    SWAR on the unsigned 32-bit value widened to int64, so no step can
    overflow or sign-extend.
    """
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR along ``dim`` (zeros for an empty axis)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while n > 1:
        half = n // 2
        folded = x[:half] | x[half:2 * half]
        if n % 2:
            folded = torch.cat([folded, x[2 * half:]])
        x = folded
        n = x.shape[0]
    return x[0]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., W*32] 0/1 -> int32 [..., W], little-endian within words."""
    *lead, nbits = bits.shape
    if nbits % WORD:
        raise ValueError(f"{nbits} bits is not a whole number of words")
    b = bits.reshape(*lead, nbits // WORD, WORD).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [..., W] -> 0/1 int8 [..., n]."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD)[
        ..., :n].to(torch.int8)
