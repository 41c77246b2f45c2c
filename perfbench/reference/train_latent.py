"""A plain float32 reference of the latent-attention training step (Kimi K2,
whose layers are DeepSeek-V3's), written from the configuration alone.

Every layer is pre-norm (RMS).  Attention is multi-head latent attention:
for x ``[B, T, d]``,

    c_q = rms(x W_qa);  q = c_q W_qb = [q_nope, q_pe]        (H heads)
    [c_kv, k_pe] = x W_kva;  [k_nope, v] = rms(c_kv) W_kvb
    q_pe, k_pe = rope(q_pe), rope(k_pe)     (k_pe one head, shared by all)
    out = softmax([q_nope, q_pe] [k_nope, k_pe]^T * s + causal) v  W_o

with YaRN's rotary frequencies (the plain ones up to the correction dim of
``beta_fast`` turns over the original context, those over ``factor`` from
that of ``beta_slow`` on, a linear ramp between) and ``s = d_qk ** -0.5 *
m ** 2``, ``m = 0.1 ln(factor) mscale_all_dim + 1``.  The first
``first_k_dense`` layers end in a SwiGLU of ``dense_d_ff``; the others in
an expert layer: scores ``sigmoid(x W_r)`` over ``router_experts``, the
top-k of the scores plus a selection bias (held at zero) chosen, their
scores normalised over the k and scaled by ``routed_scale``; of the
experts ``[expert_offset, expert_offset + n_experts)`` held here, each
keeps its first ``capacity`` assignments (token by token, then by rank of
choice) and drops the rest, with the capacity of ``router_experts``
experts; assignments to experts held elsewhere add nothing here; a shared
SwiGLU expert is added for every token.  The loss is the mean next-token
NLL over an untied head.  AdamW, the weights' stated dtypes and the float8
control are those of :mod:`perfbench.reference.train`.

Memory: each layer is recomputed in the backward pass, attention runs in
blocks of heads (each recomputed too), and the gradients accumulate into
the float32 weights' ``.grad`` over microbatches; the step's start is kept
in the stated dtypes, which hold the drawn values exactly.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import train as ref_lib
from perfbench.yardstick.latent import LatentSpec

Weights = Dict[str, torch.Tensor]


def leaf_shapes(s: LatentSpec) -> Dict[str, Tuple[int, ...]]:
    """Every weight by name, in the layout the benchmark draws it."""
    d, h, f = s.d_model, s.n_heads, s.d_ff
    rq, rkv, rope = s.q_lora_rank, s.kv_lora_rank, s.qk_rope_head_dim
    out = {"tok_embed": (s.vocab, d), "final_norm": (d,),
           "lm_head": (d, s.vocab)}
    for i in range(s.n_layers):
        p = f"layers.{i}."
        out.update({
            p + "ln1": (d,), p + "ln2": (d,),
            p + "attn.wq_a": (d, rq), p + "attn.q_norm": (rq,),
            p + "attn.wq_b": (rq, h, s.qk_head_dim),
            p + "attn.wkv_a": (d, rkv + rope), p + "attn.kv_norm": (rkv,),
            p + "attn.wkv_b": (rkv, h, s.qk_nope_head_dim + s.v_head_dim),
            p + "attn.wo": (h, s.v_head_dim, d)})
        if i < s.first_k_dense:
            out.update({p + "mlp.w_gate": (d, s.dense_d_ff),
                        p + "mlp.w_up": (d, s.dense_d_ff),
                        p + "mlp.w_down": (s.dense_d_ff, d)})
        else:
            e, fs = s.n_experts, s.n_shared_experts * f
            out.update({p + "moe.router": (d, s.router_experts),
                        p + "moe.w_gate": (e, d, f),
                        p + "moe.w_up": (e, d, f),
                        p + "moe.w_down": (e, f, d),
                        p + "moe.shared.w_gate": (d, fs),
                        p + "moe.shared.w_up": (d, fs),
                        p + "moe.shared.w_down": (fs, d)})
    return out


def yarn_inv_freq(s: LatentSpec, device) -> torch.Tensor:
    """YaRN's inverse frequencies over the ``qk_rope_head_dim`` rotary
    dims (DeepSeek-V3's ``yarn_find_correction_range`` and ramp)."""
    dim, base = s.qk_rope_head_dim, s.rope_theta

    def corr(turns):
        return dim * math.log(s.yarn_original / (turns * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(corr(s.yarn_beta_fast)), 0)
    high = min(math.ceil(corr(s.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (s.yarn_factor * base ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(s: LatentSpec) -> float:
    """``d_qk ** -0.5`` times the square of YaRN's magnitude scale."""
    m = 1.0 if s.yarn_factor <= 1 \
        else 0.1 * s.yarn_mscale_all_dim * math.log(s.yarn_factor) + 1.0
    return s.qk_head_dim ** -0.5 * m * m


class LatentReference(ref_lib.Reference):
    """The latent model over float32 weights; ``mm``, ``norm`` and the
    float8 control are :class:`perfbench.reference.train.Reference`'s."""

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """Rotate the two halves of ``x`` ``[B, T, H, rope]`` by position
        x YaRN frequency (the published ``mscale`` equals
        ``mscale_all_dim``: cos / sin carry no scale)."""
        t = x.shape[1]
        ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
            * yarn_inv_freq(self.s, x.device)
        cos = torch.cos(ang)[None, :, None]
        sin = torch.sin(ang)[None, :, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _heads(self, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """Causal softmax attention of ``[B, h, T, *]`` blocks of heads."""
        t = q.shape[2]
        scores = self.mm(q, k.transpose(-1, -2)) * softmax_scale(self.s)
        causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        return self.mm(torch.softmax(scores, -1), v)

    def attention(self, p: str, x: torch.Tensor) -> torch.Tensor:
        s, w = self.s, self.w
        b, t, d = x.shape
        h, nope, rope = s.n_heads, s.qk_nope_head_dim, s.qk_rope_head_dim
        c_q = self.norm(self.mm(x, w[p + "attn.wq_a"]), w[p + "attn.q_norm"])
        q = self.mm(c_q, w[p + "attn.wq_b"].reshape(s.q_lora_rank, -1)) \
            .view(b, t, h, s.qk_head_dim)
        kv_a = self.mm(x, w[p + "attn.wkv_a"])
        c_kv, k_pe = kv_a[..., :s.kv_lora_rank], kv_a[..., s.kv_lora_rank:]
        kv = self.mm(self.norm(c_kv, w[p + "attn.kv_norm"]),
                     w[p + "attn.wkv_b"].reshape(s.kv_lora_rank, -1)) \
            .view(b, t, h, nope + s.v_head_dim)
        k_pe = self.rope(k_pe.view(b, t, 1, rope)).expand(b, t, h, rope)
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:])], -1)
        k = torch.cat([kv[..., :nope], k_pe], -1)
        v = kv[..., nope:]
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))      # [B, H, T, *]
        per_head = 4 * b * t * t
        blk = max(1, min(h, ref_lib.SCORE_BUDGET_BYTES // per_head))
        outs = [checkpoint(self._heads, q[:, i:i + blk], k[:, i:i + blk],
                           v[:, i:i + blk], use_reentrant=False)
                for i in range(0, h, blk)]
        o = torch.cat(outs, 1).transpose(1, 2).reshape(b, t, h * s.v_head_dim)
        return self.mm(o, w[p + "attn.wo"].reshape(h * s.v_head_dim, d))

    def swiglu(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        return self.mm(F.silu(self.mm(x, w[pre + "w_gate"]))
                       * self.mm(x, w[pre + "w_up"]), w[pre + "w_down"])

    def moe(self, p: str, x: torch.Tensor) -> torch.Tensor:
        s, w = self.s, self.w
        b, t, d = x.shape
        n, k = b * t, s.top_k
        xf = x.reshape(n, d)
        scores = torch.sigmoid(self.mm(xf, w[p + "moe.router"]))
        bias = torch.zeros(s.router_experts, device=x.device)   # held at 0
        experts = torch.topk(scores + bias, k, dim=-1).indices
        gates = torch.gather(scores, 1, experts)
        gates = gates / gates.sum(-1, keepdim=True) * s.routed_scale
        cap = max(int(s.capacity_factor * n * k / s.router_experts), k)
        flat_e, flat_g = experts.reshape(-1), gates.reshape(-1)
        out = torch.zeros_like(xf)
        for j in range(s.n_experts):
            picks = (flat_e == s.expert_offset + j).nonzero()[:, 0][:cap]
            tok = picks // k
            xi = xf[tok]
            h = F.silu(self.mm(xi, w[p + "moe.w_gate"][j])) \
                * self.mm(xi, w[p + "moe.w_up"][j])
            y = self.mm(h, w[p + "moe.w_down"][j])
            out = out.index_add(0, tok, y * flat_g[picks][:, None])
        return out.view(b, t, d) + self.swiglu(p + "moe.shared.", x)

    def layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        p = f"layers.{i}."
        w = self.w
        x = x + self.attention(p, self.norm(x, w[p + "ln1"]))
        h = self.norm(x, w[p + "ln2"])
        if i < self.s.first_k_dense:
            return x + self.swiglu(p + "mlp.", h)
        return x + self.moe(p, h)

    def nll_sum(self, tokens: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
        w = self.w
        x = w["tok_embed"][tokens.long()]
        for i in range(self.s.n_layers):
            x = checkpoint(self.layer, i, x, use_reentrant=False)
        logits = self.mm(self.norm(x, w["final_norm"]), w["lm_head"])
        lab = labels.long()
        gold = torch.gather(logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        return ((torch.logsumexp(logits, -1) - gold) * (lab >= 0)).sum()

    def accumulate_grads(self, batch: Dict[str, torch.Tensor]) -> float:
        """The step's loss (mean over microbatches); the float32
        gradients (mean over microbatches) are added into each weight's
        ``.grad``."""
        mb = batch["tokens"].shape[0]
        total = 0.0
        for m in range(mb):
            tok, lab = batch["tokens"][m], batch["labels"][m]
            count = float((lab >= 0).sum().clamp(min=1))
            loss = self.nll_sum(tok, lab) / count
            (loss / mb).backward()
            total += float(loss.detach()) / mb
        return total


def run_steps(spec: LatentSpec, weights: Weights, batches: List[Dict],
              opt: Dict, precision: str = "float32") -> Dict:
    """The reference's first ``len(batches)`` steps from ``weights``
    (float32 tensors holding the drawn values; updated in place):
    the step losses, the first gradient's leaf norms as AdamW takes it
    (clipped; from the first moment), and the leaf norms of the weights'
    change over all steps, as :func:`perfbench.reference.train.run_steps`
    gives them."""
    stated = ref_lib.stated_dtype(spec)
    with ref_lib._no_tf32():
        start = {n: t.to(stated(n), copy=True) for n, t in weights.items()}
        for t in weights.values():
            t.requires_grad_(True)
        ref = LatentReference(spec, weights, precision)
        mu = {n: torch.zeros_like(t) for n, t in weights.items()}
        nu = {n: torch.zeros_like(t) for n, t in weights.items()}
        losses, first = [], None
        for i, batch in enumerate(batches):
            losses.append(ref.accumulate_grads(batch))
            grads = {n: t.grad for n, t in weights.items()}
            ref_lib.adamw(weights, grads, mu, nu, i + 1, opt, stated)
            del grads
            for t in weights.values():
                t.grad = None
            if i == 0:
                first = {n: v / (1 - opt["b1"])
                         for n, v in ref_lib.leaf_norms(mu).items()}
        change = {n: float((weights[n].detach() - start[n].float()).norm())
                  for n in weights}
    return {"losses": losses, "first_grad": first, "change": change}
