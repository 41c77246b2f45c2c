"""Checkpoint manager: atomic, asynchronous, restart-safe.

The port of ``repro/checkpoint/manager.py``, on the same disk layout,
so each side restores what the other wrote: ``<dir>/step_<n>/`` holds
one ``leaf_<i>.npy`` per leaf of the flattened state plus a
``manifest.json`` (step, leaf count, dtypes, a tree description,
metadata).  Leaves are flattened as ``jax.tree.flatten`` orders them:
mappings by sorted key, tuples (named ones too) and lists in order,
``None`` holding no leaf.  bfloat16 (and float8) leaves are stored as
their unsigned integer bits with the dtype's name in the manifest,
through ``torch.Tensor.view``; nothing needs ``ml_dtypes``.  A model's
state crosses in the reference's layout (``transformer.
state_to_reference`` / ``state_from_reference``).

Writes go to ``step_<n>.tmp/`` and are renamed into place (atomic on
POSIX), so a crash mid-save never corrupts the latest checkpoint.
``save_async`` copies the leaves to host memory before it returns (the
train loop may then update its tensors in place) and writes on a
worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# numpy has no bfloat16 / float8: store their bits
_VIEW_AS = {"bfloat16": (np.uint16, torch.int16),
            "float8_e4m3fn": (np.uint8, torch.uint8),
            "float8_e5m2": (np.uint8, torch.uint8)}


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


def flatten(tree: Any) -> Tuple[List[Any], str]:
    """Leaves in ``jax.tree.flatten``'s order, and a description of the
    structure (``*`` for a leaf)."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if _is_leaf(node):
            leaves.append(node)
            return "*"
        if isinstance(node, Mapping):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node).__name__ + "(" + ", ".join(
                f"{f}={walk(v)}" for f, v in zip(node._fields, node)) + ")"
        if isinstance(node, (tuple, list)):
            inner = ", ".join(walk(v) for v in node)
            return f"({inner})" if isinstance(node, tuple) else f"[{inner}]"
        raise TypeError(f"not a state leaf or container: {type(node)}")
    desc = walk(tree)
    return leaves, desc


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves`` (in :func:`flatten`'s order) in the structure of
    ``like``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_leaf(node):
            return next(it)
        if isinstance(node, Mapping):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        raise TypeError(type(node))
    return build(like)


def _to_host(x) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array of its own (savable) and its dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).split(".")[-1]
        if name in _VIEW_AS:
            return t.view(_VIEW_AS[name][1]).numpy().view(
                _VIEW_AS[name][0]), name
        return t.numpy(), name
    arr = np.array(x)
    name = arr.dtype.name
    if name in _VIEW_AS:
        return arr.view(_VIEW_AS[name][0]), name
    return arr, name


def _from_host(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name in _VIEW_AS:
        bits = np.asarray(arr, order="C").view(
            np.int16 if _VIEW_AS[name][0] is np.uint16 else np.uint8)
        return torch.from_numpy(bits).view(getattr(torch, name))
    return torch.from_numpy(np.asarray(arr, order="C"))


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def all_steps(self) -> list:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") and \
                    (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any,
             metadata: Optional[dict] = None) -> Path:
        """Blocking save with atomic rename."""
        leaves, desc = flatten(state)
        return self._write(step, [_to_host(x) for x in leaves], desc,
                           metadata or {})

    def save_async(self, step: int, state: Any,
                   metadata: Optional[dict] = None) -> None:
        """Snapshot to host memory now, write in the background."""
        self.wait()
        leaves, desc = flatten(state)
        host = [_to_host(x) for x in leaves]

        def work():
            self._write(step, host, desc, metadata or {})

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host_leaves, desc: str,
               metadata: dict) -> Path:
        with self._lock:
            final = self._step_dir(step)
            tmp = Path(str(final) + ".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            dtypes = []
            for i, (arr, name) in enumerate(host_leaves):
                dtypes.append(name)
                np.save(tmp / f"leaf_{i:05d}.npy", arr)
            manifest = {
                "step": step,
                "n_leaves": len(host_leaves),
                "dtypes": dtypes,
                "treedef": desc,
                "metadata": metadata,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
            return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, like: Any, step: Optional[int] = None,
                device: DeviceLike = None) -> Tuple[Any, int, dict]:
        """Restore into the structure of ``like``.

        Each leaf becomes a tensor on ``device`` if one is given, else on
        the device of ``like``'s tensor leaf (one on ``meta`` only gives
        the structure), else on cuda (``None``), which raises without a
        card.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        leaves, _ = flatten(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint/model structure mismatch: {manifest['n_leaves']}"
                f" leaves on disk, {len(leaves)} in the target")
        dtypes = manifest.get("dtypes", [None] * len(leaves))
        restored = []
        for i, leaf in enumerate(leaves):
            if device is not None:
                dev = resolve_device(device)
            elif isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
                dev = leaf.device
            else:
                dev = resolve_device(None)
            arr = np.load(d / f"leaf_{i:05d}.npy")
            restored.append(_from_host(arr, dtypes[i]).to(dev))
        return unflatten(like, restored), step, manifest["metadata"]
