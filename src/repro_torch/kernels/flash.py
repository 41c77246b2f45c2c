"""Fused causal attention on the card: online softmax, forward and backward.

:func:`attention` is causal self-attention over full sequences, q ``[B,
T, H, D]``, k ``[B, T, Hkv, D]``, v ``[B, T, Hkv, Dv]`` -> ``[B, T, H,
Dv]``, a ``torch.autograd.Function`` over four CUDA C++ kernels (source:
``csrc/flash_attention.cu``, whose header gives the design):

- ``attention_fwd``: a block per (batch, query head, query tile) walks
  the key / value tiles up to the causal bound with a float32 running
  max and denominator, P cast to bf16 before the value product; it
  writes O and the float32 log-sum-exp ``[B, H, T]``, never the logits.
- ``attention_bwd_pre``: ``delta = rowsum(dO * O)`` in float32.
- ``attention_bwd_dkdv``: a block per (batch, kv head, key tile), summing
  over the kv head's ``n_rep`` query heads and the query tiles at or
  after it; ``attention_bwd_dq``: a block per (batch, query head, query
  tile) over the key tiles up to the diagonal.  Each output row has one
  writer, so no atomics: the gradients are the same bits from run to
  run.

It replaces no TPU kernel: the JAX package leaves attention to XLA.  It
was added because the eager chain it replaces (``models/attention.py::
_sdpa``) writes the ``[B, H, T, T]`` logits to device memory in bf16 and
float32 and passes over them about ten times forward and as often
backward (4.3-8.6 GB a call at T = 4,096).

Head dims: the cases of :data:`CASES` (score dims, value dims), each
compiled at its first launch into a library of its own for each dtype
(``build.compile_library``; tile sizes fixed in the source, no
autotuning), so a run builds the one it uses.  bf16 runs on the tensor
cores; float32 (the float32 configs held against the CPU on the card)
on the CUDA cores, in full float32.

The wrapper checks device, dtype, shapes and strides, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream
without synchronising, raises on a launch's error and counts each launch
in :data:`LAUNCHES`.  What the kernels do not take raises; nothing falls
back.  :func:`attention_ref` is the plain float32 version the tests hold
the kernels against.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = build.CSRC / "flash_attention.cu"

# launches per kernel since the last reset_launches()
LAUNCHES = {"attention_fwd": 0, "attention_bwd_pre": 0,
            "attention_bwd_dkdv": 0, "attention_bwd_dq": 0}

DTYPES = (torch.bfloat16, torch.float32)
#: (score dims, value dims) the kernels are built for: 64 (stablelm,
#: granite), 128 (qwen3, llama-vision's prefill), 192 / 128 (Kimi K2's
#: MLA, nope 128 + rope 64) and 32 (the reduced configs)
CASES = ((32, 32), (64, 64), (128, 128), (192, 128))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plan(d: int, dv: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The case of score dims ``d`` and value dims ``dv``; ``ValueError``
    on what the kernels do not take."""
    if dtype not in DTYPES:
        raise ValueError(f"fused attention takes {DTYPES}, not {dtype}")
    if (d, dv) not in CASES:
        raise ValueError(f"fused attention takes (score, value) head dims "
                         f"{CASES}, not {(d, dv)}")
    return d, dv


def _stem(d: int, dv: int, dtype: torch.dtype) -> str:
    return f"flash_d{d}_v{dv}" + ("_f32" if dtype == torch.float32 else "")


def flags(d: int, dv: int, dtype: torch.dtype = torch.bfloat16
          ) -> Tuple[str, ...]:
    return (*build.NVCC_FLAGS, f"-DFLASH_D={d}", f"-DFLASH_DV={dv}",
            f"-DFLASH_F32={int(dtype == torch.float32)}")


def library_path(d: int, dv: int, dtype: torch.dtype = torch.bfloat16
                 ) -> Path:
    """Where case ``(d, dv)``'s library for ``dtype`` is built (its
    ``.log`` beside it: registers, shared memory and spills)."""
    return build.library_path(_stem(d, dv, dtype), (SOURCE,),
                              flags(d, dv, dtype))


@functools.cache
def _lib(d: int, dv: int, dtype: torch.dtype) -> ctypes.CDLL:
    path = build.compile_library(_stem(d, dv, dtype), (SOURCE,),
                                 flags(d, dv, dtype))
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_error_string.argtypes = [i32]
    lib.flash_error_string.restype = ctypes.c_char_p
    lib.flash_case.argtypes = [ptr]
    lib.flash_case.restype = None
    lib.flash_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [f32, ptr]
    lib.flash_fwd.restype = i32
    lib.flash_bwd.argtypes = [ptr] * 11 + [i32] * 4 + [f32, ptr]
    lib.flash_bwd.restype = i32
    return lib


def tiles(d: int, dv: int) -> dict:
    """Case ``(d, dv)``'s bf16 block tiles as built: rows of the forward's
    and dQ's query tiles, keys of the dK / dV tile, and each kernel's
    dynamic shared memory in bytes."""
    out = (ctypes.c_int * 8)()
    _lib(d, dv, torch.bfloat16).flash_case(out)
    return dict(d=out[0], dv=out[1], fwd_rows=out[2], dkdv_keys=out[3],
                dq_rows=out[4], smem=dict(attention_fwd=out[5],
                                          attention_bwd_dkdv=out[6],
                                          attention_bwd_dq=out[7]))


def _aligned(x: torch.Tensor) -> bool:
    """Rows start on 16 bytes: the bf16 kernels copy them 16 bytes at a
    time."""
    per = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in x.stride()[:3])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           n_rep: int) -> Tuple[int, int]:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"fused attention runs on one CUDA device: q on "
                         f"{q.device}, k on {k.device}, v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("q, k, v must be [B, T, heads, dims]")
    b, t, h, d = q.shape
    hk = k.shape[2]
    if k.shape != (b, t, hk, d) or v.shape[:3] != (b, t, hk):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if n_rep < 1 or hk * n_rep != h:
        raise ValueError(f"{h} query heads are not {n_rep} x {hk} kv heads")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v need a last-dim stride of 1")
    if q.dtype == torch.bfloat16 and not all(map(_aligned, (q, k, v))):
        raise ValueError("q, k, v rows must start on 16 bytes")
    if t < 1 or b < 1:
        raise ValueError(f"empty batch or sequence: {tuple(q.shape)}")
    return plan(d, v.shape[-1], q.dtype)


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: {lib.flash_error_string(err).decode()}")


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_rep: int,
            scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O ``[B, T, H, Dv]`` (q's dtype, contiguous) and the float32
    log-sum-exp of the scaled logits ``[B, H, T]``; ``scale`` defaults to
    ``1 / sqrt(D)``.  One launch."""
    d, dv = _check(q, k, v, n_rep)
    b, t, h, _ = q.shape
    o = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _lib(d, dv, q.dtype)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), _strides(q, k, v),
            b, t, h, n_rep, _scale(d, scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "attention_fwd")
    LAUNCHES["attention_fwd"] += 1
    return o, lse


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
             n_rep: int, scale: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV (contiguous, in q's dtype) from :func:`forward`'s O and
    log-sum-exp and the output's gradient ``do``.  Three launches."""
    d, dv = _check(q, k, v, n_rep)
    b, t, h, _ = q.shape
    hk = k.shape[2]
    if o.shape != (b, t, h, dv) or do.shape != o.shape or \
            lse.shape != (b, h, t) or do.dtype != q.dtype or \
            o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} "
                         f"({do.dtype}) or lse {tuple(lse.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if not (o.is_contiguous() and do.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("o, do and lse must be contiguous")
    delta = torch.empty_like(lse)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hk, d), dtype=q.dtype, device=q.device)
    dv_ = torch.empty((b, t, hk, dv), dtype=q.dtype, device=q.device)
    lib = _lib(d, dv, q.dtype)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(),
            _strides(q, k, v), b, t, h, n_rep, _scale(d, scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "attention backward")
    for name in ("attention_bwd_pre", "attention_bwd_dkdv",
                 "attention_bwd_dq"):
        LAUNCHES[name] += 1
    return dq, dk, dv_


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_rep, scale):
        o, lse = forward(q, k, v, n_rep, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_rep, ctx.scale = n_rep, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, o, lse, do.contiguous(), ctx.n_rep,
                              ctx.scale)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_rep: int,
              scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention on the card with its backward: ``[B, T, H, Dv]``
    in q's dtype.  Same function as :func:`attention_ref`."""
    return _Attention.apply(q, k, v, n_rep, scale)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_rep: int, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version in float32: O ``[B, T, H, Dv]`` and the
    log-sum-exp of the scaled, causally masked logits ``[B, H, T]``."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    if n_rep > 1:
        kf = kf.repeat_interleave(n_rep, dim=2)
        vf = vf.repeat_interleave(n_rep, dim=2)
    t = q.shape[1]
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * _scale(q.shape[-1], scale)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", torch.exp(s - lse[..., None]), vf)
    return o, lse
