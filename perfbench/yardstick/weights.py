"""The benchmark's weights, drawn on the device from the seed.

One generator on the device draws every matrix of the model from one flat
run of standard normals, in a few large calls, in the order of the leaves'
names; each leaf is its run scaled by ``1 / sqrt(fan_in)`` (0.02 for the
embedding) and rounded to the dtype it is stated in.  Norm weights are
ones.  The program's parameters and the reference's are filled by the
same call, so both start from the same values.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

CHUNK = 1 << 27          # normals a call: 512 MiB of float32

NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def is_norm(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in NORMS


def scale_of(name: str, shape: Sequence[int]) -> float:
    """The draw's scale for a matrix leaf, by its name and shape."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "tok_embed":
        return 0.02
    if leaf == "wo":                       # [H, hd, d]
        fan_in = shape[0] * shape[1]
    elif ".moe." in name and leaf != "router" and len(shape) == 3:
        fan_in = shape[1]                  # [E, in, out]
    else:
        fan_in = shape[0]                  # [in, ...]
    return 1.0 / math.sqrt(fan_in)


@torch.no_grad()
def fill(dest: Dict[str, torch.Tensor], seed: int,
         stated: Callable[[str], torch.dtype]) -> None:
    """Write the seed's weights into ``dest`` (name -> tensor, any dtype),
    each value first rounded to ``stated(name)``."""
    names = sorted(dest)
    dev = dest[names[0]].device
    mats = [n for n in names if not is_norm(n)]
    total = sum(dest[n].numel() for n in mats)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=torch.bfloat16, device=dev)
    for at in range(0, total, CHUNK):
        n = min(CHUNK, total - at)
        flat[at:at + n] = torch.randn(n, generator=gen, device=dev)
    off = 0
    for name in mats:
        t = dest[name]
        part = flat[off:off + t.numel()].view(t.shape).float()
        t.copy_((part * scale_of(name, t.shape)).to(stated(name)))
        off += t.numel()
    del flat
    for name in names:
        if is_norm(name):
            dest[name].fill_(1)
