"""Serving entry point: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --prompt-len 64 --gen 32 [--int8-kv] [--smoke] \
        [--device cpu]

Random weights from a seeded generator (``--smoke``: the reduced
config); the encdec and vlm families get their stub frontends' inputs
(``serve.engine.frontend_inputs``) from it too.  Prints the prefill latency, the decode throughput and step
time, and sample tokens.  Each path runs once untimed first, and on a
card the timed regions start and end with a synchronise.  Without
``--device`` it runs on cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf_lib
from repro_torch.serve import engine as serve_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.gen < 2:
        ap.error("--gen must be >= 2 (one prefill token, decode steps)")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = tf_lib.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    extra = serve_lib.frontend_inputs(cfg, args.batch, gen, dev)

    max_len = args.prompt_len + args.gen
    prefill = serve_lib.make_prefill_step(cfg, max_len=max_len)
    decode = serve_lib.make_decode_step(cfg)

    def decode_all(cache, tok):
        out = [tok]
        for _ in range(args.gen - 1):
            logits, cache = decode(params, cache, tok, extra)
            tok = serve_lib.greedy_token(logits)
            out.append(tok)
        return torch.cat(out, dim=1)

    # untimed warm-up of both paths (allocator, library handles)
    logits, cache = prefill(params, prompt, extra)
    decode_all(cache, serve_lib.greedy_token(logits))
    _sync(dev)

    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, extra)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = serve_lib.greedy_token(logits)
    t0 = time.perf_counter()
    tokens = decode_all(cache, tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    steps = args.gen - 1
    print(f"arch={cfg.name} kv={cfg.kv_cache_dtype} batch={args.batch} "
          f"device={dev}")
    print(f"prefill({args.prompt_len} tok): {t_prefill * 1e3:.1f} ms")
    print(f"decode: {steps * args.batch / t_decode:.1f} tok/s "
          f"({t_decode / steps * 1e3:.1f} ms/step)")
    print(f"sample tokens[0,:8]: {tokens[0, :8].tolist()}")


if __name__ == "__main__":
    main()
