"""End-to-end training launcher with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch stablelm-1.6b --steps 200 [--smoke] [--device cpu]

The port of ``repro/launch/train.py``.  ``--smoke`` runs the reduced
config; without it the full config trains on the one device it is given
(``--device``, default cuda, which raises without a card).  The
reference launches the full config on its production mesh, which the
port's ``launch.mesh.make_production_mesh`` refuses below 256 cards, and
the port has no multi-card train step.  Batches come from the token
pipeline (a pure function of the step), the step is microbatched and
rematerialised, checkpoints are written asynchronously every
``--ckpt-every`` steps and at the end (two kept).  Restart-safety: if
the checkpoint directory already has state, training resumes from the
latest step, so a killed run rerun with the same command replays the
same batches from there.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frontend_shapes(cfg) -> dict:
    """The token pipeline's ``extra_shapes`` for the stub frontends: the
    encdec family's ``enc_frames`` ``(enc_seq, d)`` and the vlm family's
    ``image_embeds`` ``(vision_tokens, vision_dim)``, float32."""
    if cfg.family == "encdec":
        return {"enc_frames": ((cfg.enc_seq, cfg.d_model), np.float32)}
    if cfg.family == "vlm":
        return {"image_embeds": ((cfg.vision_tokens, cfg.vision_dim),
                                 np.float32)}
    return {}


def run(arch: str, steps: int, smoke: bool, batch: int, seq: int,
        ckpt_dir: str, ckpt_every: int, microbatches: int,
        lr: float = 3e-4, log_every: int = 10, config=None,
        device: DeviceLike = None,
        seed: int = 0) -> dict:
    """Train ``arch`` from step 0, or from the latest checkpoint under
    ``ckpt_dir``, to ``steps``.  Returns the reference's summary
    (``first_loss``, ``last_loss``, ``steps_run``, ``resumed_from``)
    plus every step's ``losses`` and wall seconds (``step_s``; each
    step reads its loss back, which synchronises) and the final
    ``state`` ``(params, opt_state)``.  The reference's ``use_mesh`` is
    absent: the port trains on one device."""
    dev = resolve_device(device)
    cfg = config if config is not None else get_config(arch)
    if smoke and config is None:
        cfg = cfg.reduced()
    opt_cfg = optim_lib.OptConfig(lr=lr, warmup_steps=min(50, steps // 5),
                                  total_steps=steps)
    train_step = step_lib.make_train_step(cfg, opt_cfg, microbatches)

    pipe = TokenPipeline(cfg.vocab, seq, batch, microbatches=microbatches,
                         extra_shapes=frontend_shapes(cfg), seed=0)
    mgr = CheckpointManager(ckpt_dir, keep=2)

    params, opt_state = step_lib.init_train_state(cfg, opt_cfg, seed, dev)
    start = 0
    if mgr.latest_step() is not None:
        like = tf_lib.state_to_reference(params, opt_state, device="meta")
        state, start, meta = mgr.restore(like, device="cpu")
        params, opt_state = tf_lib.state_from_reference(
            state, cfg, params, opt_state)
        del state
        print(f"[restore] resumed from step {start} "
              f"(loss was {meta.get('loss')})")
    losses, step_s = [], []
    t0 = time.time()
    for s in range(start, steps):
        t_step = time.perf_counter()
        batch_dev = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(s).items()}
        params, opt_state, metrics = train_step(params, opt_state,
                                                batch_dev)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        if (s + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            print(f"step {s+1:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms/step", flush=True)
            t0 = time.time()
        if (s + 1) % ckpt_every == 0 or s + 1 == steps:
            mgr.save_async(s + 1, tf_lib.state_to_reference(
                params, opt_state), {"loss": loss, "arch": arch})
    mgr.wait()
    _sync(dev)
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps_run": len(losses), "resumed_from": start,
            "losses": losses, "step_s": step_s,
            "state": (params, opt_state)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.arch, args.steps, args.smoke, args.batch, args.seq,
              str(Path(args.ckpt_dir) / args.arch), args.ckpt_every,
              args.microbatches, device=args.device)
    summary = {k: out[k] for k in ("first_loss", "last_loss", "steps_run",
                                   "resumed_from")}
    print(f"done: {summary}")


if __name__ == "__main__":
    main()
