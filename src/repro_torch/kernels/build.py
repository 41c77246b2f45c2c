"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so they compile
in seconds without PyTorch's headers.  Each shared library goes into
``build/repro_torch_kernels/`` at the repository root, named by a hash
of its sources and flags, and is built at first use: a checkout that
holds only the sources builds it on its first kernel call.  The
availability scan is one library (:func:`build`, :func:`load`); the
fused attention one per head-dim case (:func:`compile_library`, from
``kernels/flash.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "availscan.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found under {home}/bin or on PATH: the CUDA kernels "
        f"can only be built where the CUDA toolkit is installed")


def library_path(stem: str = "availscan", sources=SOURCES,
                 flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the availability scan unless this exact build exists; its
    path."""
    return compile_library("availscan", SOURCES, NVCC_FLAGS)


def compile_library(stem: str, sources, flags) -> Path:
    """Compile ``sources`` with ``flags`` into a shared library unless
    this exact build exists; its path.

    ``nvcc``'s resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``.log``.
    """
    path = library_path(stem, sources, flags)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's C signature set."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("availscan_candidates_per_block",
                 "availscan_select_max_blocks",
                 "availscan_select_scratch_ints", "availscan_mr_max_words"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.availscan_smem_rows.argtypes = [i32, i32]
    lib.availscan_smem_rows.restype = i32
    lib.availscan_empty.argtypes = [i32, i32, ptr]
    lib.availscan_empty.restype = i32
    lib.availscan_error_string.argtypes = [i32]
    lib.availscan_error_string.restype = ctypes.c_char_p
    lib.availscan_rects.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.availscan_rects.restype = i32
    lib.availscan_one.argtypes = [ptr] * 2 + [i32, ptr] + [i32] * 5 + [ptr]
    lib.availscan_one.restype = i32
    lib.availscan_select.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.availscan_select.restype = i32
    lib.availscan_rects_mr.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.availscan_rects_mr.restype = i32
    lib.availscan_one_mr.argtypes = [ptr] * 4 + [i32, ptr] + [i32] * 5 + [ptr]
    lib.availscan_one_mr.restype = i32
    lib.availscan_select_mr.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.availscan_select_mr.restype = i32
    return lib
