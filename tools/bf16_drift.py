"""How far a model's bfloat16 outputs move under rounding, on the card.

For each architecture at full width (random weights from ``--seed``,
``--batch`` prompts of ``--prompt`` tokens, ``--gen`` greedy tokens)
this prints, as one JSON line each:

* ``decode``: max ``|decode - forward|`` of the logits at each generated
  position (the check of ``chip_smoke.py``'s serve phase), and how many
  logits lie beyond ``0.12 + 0.12 |forward|``, once with cuBLAS's
  reduced-precision bfloat16 reductions allowed (PyTorch's default) and
  once with them off;
* ``decode_by_depth``: the first, with the default reductions, for the
  model's first ``k`` layers (the same weights) at several depths;
* ``lengths``: the same chunked forward run over the prompt alone and
  over prompt + generated tokens, compared on the prompt's positions
  (no decode involved: only the sequence length differs), at several
  depths (the first ``k`` layers of the same weights), as max and rms
  of the final hidden state's difference beside the hidden state's rms.

Run it on a machine with a card::

    PYTHONPATH=src python tools/bf16_drift.py --arch zamba2-7b xlstm-1.3b
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve import engine

TOL = 0.12


def _generate(params, cfg, prompt, gen):
    prefill = engine.make_prefill_step(cfg, max_len=prompt.shape[1] + gen)
    decode = engine.make_decode_step(cfg)
    logits, cache = prefill(params, prompt)
    tok = engine.greedy_token(logits)
    toks, logs = [tok], [logits]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = engine.greedy_token(logits)
        toks.append(tok)
        logs.append(logits)
    return torch.cat(toks, 1), torch.stack(logs, 1)


@torch.inference_mode()
def _forward_logits(params, cfg, seq, t0):
    hid = tf.forward(params, cfg, seq).hidden[:, t0:]
    return (hid @ params.head).float()


def decode_gap(params, cfg, prompt, gen):
    toks, logits = _generate(params, cfg, prompt, gen)
    seq = torch.cat([prompt, toks[:, :-1].long()], 1)
    ref = _forward_logits(params, cfg, seq, prompt.shape[1] - 1)
    err = (logits - ref).abs()
    bad = err > TOL + TOL * ref.abs()
    return dict(max_by_position=[round(float(x), 4)
                                 for x in err.amax(dim=(0, 2))],
                beyond=int(bad.sum()), of=bad.numel(),
                logit_rms=float(ref.pow(2).mean().sqrt()))


def _first_layers(params, cfg, k):
    """``(params, cfg)`` of the model's first ``k`` layers, sharing the
    weights."""
    c = dataclasses.replace(cfg, n_layers=k)
    p = copy.copy(params)
    p._modules = dict(params._modules)
    n_mixers = k
    if cfg.family == "ssm":
        n_s, _ = tf._xlstm_groups(c)
        n_mixers = k - n_s
        if params.slstm_layers is not None:
            p._modules["slstm_layers"] = params.slstm_layers[:n_s]
    p._modules["layers"] = params.layers[:n_mixers]
    return p, c


@torch.inference_mode()
def length_gap(params, cfg, seq, t, depths):
    out = {}
    for k in depths:
        p, c = _first_layers(params, cfg, k)
        short = tf.forward(p, c, seq[:, :t]).hidden.float()
        full = tf.forward(p, c, seq).hidden[:, :t].float()
        d = (short - full).abs()
        out[k] = dict(max=float(d.max()), rms=float(d.pow(2).mean().sqrt()),
                      hidden_rms=float(full.pow(2).mean().sqrt()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3-4b", "zamba2-7b", "xlstm-1.3b"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    back = torch.backends.cuda.matmul
    for arch in args.arch:
        cfg = get_config(arch)
        params = tf.init_params(cfg, seed=args.seed, device=dev)
        g = torch.Generator(device=dev).manual_seed(args.seed)
        prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                               generator=g, device=dev)
        seq = torch.randint(0, cfg.vocab, (args.batch, args.prompt
                                           + args.gen - 1),
                            generator=g, device=dev)
        depths = sorted({d for d in (1, 2, 4, 6, 8, 12, 16, 32, 48, 64)
                         if d < cfg.n_layers} | {cfg.n_layers})
        row = {"arch": arch, "dtype": cfg.dtype}
        for reduced in (True, False):
            back.allow_bf16_reduced_precision_reduction = reduced
            row[f"reduced_{reduced}"] = dict(
                decode=decode_gap(params, cfg, prompt, args.gen),
                lengths=length_gap(params, cfg, seq, args.prompt, depths))
        back.allow_bf16_reduced_precision_reduction = True
        row["decode_by_depth"] = {
            k: decode_gap(*_first_layers(params, cfg, k), prompt, args.gen)
            for k in depths if k < cfg.n_layers}
        print(json.dumps(row), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
