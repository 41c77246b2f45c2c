"""Serving-step factories: batched prefill and single-token decode.

The port of ``repro/serve/engine.py``.  ``generate`` drives a greedy
prefill + decode loop for the examples, the tests and the card's smoke
run.  The reference compiles each step with ``jax.jit``; the port runs
them eagerly under :func:`torch.inference_mode`, and the decode loop
reads nothing back to the host until the tokens are returned.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_lib


def make_prefill_step(cfg: ModelConfig,
                      max_len: Optional[int] = None) -> Callable:
    @torch.inference_mode()
    def prefill_step(params, tokens, extra=None):
        return tf_lib.prefill(params, cfg, tokens, extra,
                              max_len=max_len or tokens.shape[1])
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    @torch.inference_mode()
    def decode_step(params, cache, tokens, extra=None):
        return tf_lib.decode_step(params, cfg, cache, tokens, extra)
    return decode_step


def frontend_inputs(cfg: ModelConfig, batch: int,
                    gen: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """The stub frontends' ``extra``: the encdec family's precomputed
    audio frames ``enc_frames`` ``[B, enc_seq, d]`` or the vlm family's
    patch embeddings ``image_embeds`` ``[B, vision_tokens, vision_dim]``,
    float32 normals x 0.1 from ``gen`` (the reference's launcher draws
    the same distribution); empty for the other families."""
    if cfg.family == "encdec":
        shape = (batch, cfg.enc_seq, cfg.d_model)
    elif cfg.family == "vlm":
        shape = (batch, cfg.vision_tokens, cfg.vision_dim)
    else:
        return {}
    name = "enc_frames" if cfg.family == "encdec" else "image_embeds"
    return {name: torch.randn(shape, generator=gen, device=device) * 0.1}


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """``[B, V]`` logits -> ``int32[B, 1]``, the first maximum's index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def generate(params, cfg: ModelConfig, prompt: torch.Tensor,
             n_tokens: int, extra: Optional[Dict] = None) -> torch.Tensor:
    """Greedy generation: prefill the prompt then decode ``n_tokens``
    (the first from the prefill's logits); returns ``int32[B, n]``."""
    t = prompt.shape[1]
    prefill_fn = make_prefill_step(cfg, max_len=t + n_tokens)
    decode_fn = make_decode_step(cfg)
    logits, cache = prefill_fn(params, prompt, extra)
    tok = greedy_token(logits)
    out = [tok]
    for _ in range(n_tokens - 1):
        logits, cache = decode_fn(params, cache, tok, extra)
        tok = greedy_token(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
