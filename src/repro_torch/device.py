"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises.

    The port never falls back to the CPU on its own: a caller that
    wants the CPU (the tests) passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def to_device(tree, device: torch.device):
    """A tree of tensors (named tuples and tuples; ``None`` and other
    leaves kept) on ``device``.  A tensor already there is returned as
    it is, so on one device this copies nothing."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_device(x, device) for x in tree)
    return tree
