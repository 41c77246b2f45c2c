"""The sizes of a configuration as the benchmark reads them.

``configs/<name>.json`` keeps the published numbers and, under ``model``,
the configuration as the port runs it (the keyword arguments of the port's
``ModelConfig``).  :class:`Spec` is the benchmark's own view of that block:
the FLOP counts and the reference read it, so neither depends on the
program's config class.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Spec:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    rope_theta: float = 10_000.0
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @classmethod
    def from_model(cls, model: Dict[str, Any]) -> "Spec":
        """A config file's ``model`` block; refuses a key the benchmark
        does not model, since its counts and reference would ignore it."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(model) - names)
        if unknown:
            raise ValueError(f"model keys the benchmark does not model: "
                             f"{unknown}")
        return cls(**model)
