"""A plain float32 reference of the dense and MoE training step.

The model (pre-norm decoder: RMS norm, rotary causal attention with grouped
KV heads, a SwiGLU MLP or a capacity-bounded top-k mixture of experts, an
untied head), its loss (mean next-token NLL, plus 0.01 x load balance and
1e-3 x router z for experts) and AdamW (global-norm clipping, warmup and
cosine decay, decoupled decay on matrices and on per-layer norm weights,
moments in float32), written from the configuration alone.  Weights are
stored in the dtype the configuration states (the router in float32), so
each step's update is rounded to that dtype as the configuration's
parameters are; all arithmetic is float32 with TF32 off.

Memory: every layer is recomputed in the backward pass, and a dense model
takes its batch in blocks of rows (the loss is a mean over all rows, so
the blocks' gradients sum to the batch's).  A model with experts takes
each microbatch whole, since its capacity is the microbatch's.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 with one scale a tensor (the gradient passes
straight through), the step a lower precision would take.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.yardstick.spec import Spec

Weights = Dict[str, torch.Tensor]
E4M3_MAX = 448.0
# rows of attention scores a dense block may hold: [rows, H, T, T] float32
SCORE_BUDGET_BYTES = 3 << 30


def leaf_shapes(s: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every weight by name, in the layout the benchmark draws it."""
    d, hd, hq, hkv = s.d_model, s.hd, s.n_heads, s.n_kv_heads
    out = {"tok_embed": (s.vocab, d), "final_norm": (d,)}
    if not s.tie_embeddings:
        out["lm_head"] = (d, s.vocab)
    for i in range(s.n_layers):
        p = f"layers.{i}."
        out.update({p + "ln1": (d,), p + "ln2": (d,),
                    p + "attn.wq": (d, hq, hd), p + "attn.wk": (d, hkv, hd),
                    p + "attn.wv": (d, hkv, hd), p + "attn.wo": (hq, hd, d)})
        if s.family == "moe":
            e, f = s.n_experts, s.d_ff
            out.update({p + "moe.router": (d, e),
                        p + "moe.w_gate": (e, d, f),
                        p + "moe.w_up": (e, d, f),
                        p + "moe.w_down": (e, f, d)})
        else:
            out.update({p + "mlp.w_gate": (d, s.d_ff),
                        p + "mlp.w_up": (d, s.d_ff),
                        p + "mlp.w_down": (s.d_ff, d)})
    return out


def stated_dtype(s: Spec):
    """The dtype each leaf is stored in: the router float32, the rest the
    configuration's."""
    dt = getattr(torch, s.dtype)
    return lambda name: torch.float32 if name.endswith("router") else dt


def decayed(name: str, shape) -> bool:
    """Decoupled weight decay: matrices, and every per-layer leaf (the
    configuration's optimizer stacks per-layer leaves, so their norm
    weights are matrices there); not the final norm."""
    return len(shape) >= 2 or name.startswith("layers.")


class Reference:
    def __init__(self, spec: Spec, weights: Weights,
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.s = spec
        self.w = weights
        self.fp8 = precision == "fp8"

    # -- arithmetic --------------------------------------------------------
    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._q(a) @ self._q(b)

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self._q(a), self._q(b))

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.s.norm_eps) * w

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """Rotate the two halves of each head by position x frequency."""
        t, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / (self.s.rope_theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    # -- layers ----------------------------------------------------------------
    def attention(self, p: str, x: torch.Tensor) -> torch.Tensor:
        s, w = self.s, self.w
        b, t, d = x.shape
        hq, hkv, hd = s.n_heads, s.n_kv_heads, s.hd
        q = self.mm(x, w[p + "attn.wq"].reshape(d, hq * hd)).view(b, t, hq, hd)
        k = self.mm(x, w[p + "attn.wk"].reshape(d, hkv * hd)).view(b, t, hkv, hd)
        v = self.mm(x, w[p + "attn.wv"].reshape(d, hkv * hd)).view(b, t, hkv, hd)
        q, k = self.rope(q), self.rope(k)
        rep = hq // hkv                      # kv head j serves q heads j*rep..
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))      # [B, H, T, hd]
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        o = self.mm(torch.softmax(scores, -1), v)              # [B, H, T, hd]
        o = o.transpose(1, 2).reshape(b, t, hq * hd)
        return self.mm(o, w[p + "attn.wo"].reshape(hq * hd, d))

    def mlp(self, p: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        return self.mm(F.silu(self.mm(x, w[p + "mlp.w_gate"]))
                       * self.mm(x, w[p + "mlp.w_up"]), w[p + "mlp.w_down"])

    def moe(self, p: str, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Top-k experts with a capacity a expert: assignments are taken
        token by token (then by rank of choice); an expert keeps its first
        ``capacity`` and drops the rest.  Returns (out, load balance,
        router z)."""
        s, w = self.s, self.w
        b, t, d = x.shape
        n, e, k = b * t, s.n_experts, s.top_k
        xf = x.reshape(n, d)
        logits = self.mm(xf, w[p + "moe.router"])
        probs = torch.softmax(logits, -1)
        gates, experts = torch.topk(probs, k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True)
        cap = max(int(s.capacity_factor * n * k / e), k)
        flat_e = experts.reshape(-1)
        flat_g = gates.reshape(-1)
        out = torch.zeros_like(xf)
        for j in range(e):
            picks = (flat_e == j).nonzero()[:, 0][:cap]   # in token order
            tok = picks // k
            xi = xf[tok]
            h = F.silu(self.mm(xi, w[p + "moe.w_gate"][j])) \
                * self.mm(xi, w[p + "moe.w_up"][j])
            y = self.mm(h, w[p + "moe.w_down"][j])
            out = out.index_add(0, tok, y * flat_g[picks][:, None])
        top1 = F.one_hot(experts[:, 0], e).float().mean(0)
        lb = e * torch.sum(probs.mean(0) * top1)
        z = torch.logsumexp(logits, -1).square().mean()
        return out.view(b, t, d), lb, z

    def layer(self, i: int, x: torch.Tensor):
        p = f"layers.{i}."
        w = self.w
        x = x + self.attention(p, self.norm(x, w[p + "ln1"]))
        h = self.norm(x, w[p + "ln2"])
        if self.s.family == "moe":
            y, lb, z = self.moe(p, h)
            return x + y, lb, z
        zero = x.new_zeros(())
        return x + self.mlp(p, h), zero, zero

    # -- loss --------------------------------------------------------------
    def nll_sum(self, tokens: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(sum of NLL over labels >= 0, mean load balance over layers,
        mean router z over layers) for ``tokens`` ``[B, T]``."""
        w, s = self.w, self.s
        x = w["tok_embed"][tokens.long()]
        lbs, zs = [], []
        for i in range(s.n_layers):
            x, lb, z = checkpoint(self.layer, i, x, use_reentrant=False)
            lbs.append(lb)
            zs.append(z)
        head = w["tok_embed"].T if s.tie_embeddings else w["lm_head"]
        x = self.norm(x, w["final_norm"])
        logits = self.mm(x, head)
        lab = labels.long()
        gold = torch.gather(logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        nll = (torch.logsumexp(logits, -1) - gold) * (lab >= 0)
        return nll.sum(), torch.stack(lbs).mean(), torch.stack(zs).mean()

    def loss_and_grads(self, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[float, Dict[str, torch.Tensor]]:
        """The step's loss (mean over microbatches) and float32 gradients
        (mean over microbatches) for a batch ``[mb, B, T]``."""
        w, s = self.w, self.s
        grads = {n: torch.zeros_like(t, dtype=torch.float32)
                 for n, t in w.items()}
        mb = batch["tokens"].shape[0]
        total = 0.0
        for m in range(mb):
            tok, lab = batch["tokens"][m], batch["labels"][m]
            count = float((lab >= 0).sum().clamp(min=1))
            rows = tok.shape[0]
            if s.family == "moe":
                block = rows
            else:
                per_row = 4 * s.n_heads * tok.shape[1] ** 2
                block = max(1, min(rows, SCORE_BUDGET_BYTES // per_row))
            for r in range(0, rows, block):
                nll, lb, z = self.nll_sum(tok[r:r + block], lab[r:r + block])
                loss = nll / count
                if s.family == "moe":
                    loss = loss + 0.01 * lb + 1e-3 * z
                g = torch.autograd.grad(loss / mb, list(w.values()),
                                        allow_unused=True)
                for (name, _), gi in zip(w.items(), g):
                    if gi is not None:
                        grads[name] += gi
                total += float(loss.detach()) / mb
        return total, grads


def schedule(step: int, opt: Dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(w: Weights, grads: Weights, mu: Weights, nu: Weights, step: int,
          opt: Dict, stated) -> None:
    """One AdamW step in float32, in place; each weight is then rounded to
    its stated dtype."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(opt["grad_clip"] / (gnorm + 1e-12), 1.0)
    lr = schedule(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for name, p in w.items():
        g = grads[name] * scale
        mu[name].mul_(b1).add_(g, alpha=1 - b1)
        nu[name].mul_(b2).add_(g * g, alpha=1 - b2)
        delta = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + opt["eps"])
        if decayed(name, p.shape):
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
        p.copy_(p.to(stated(name)).float())


def leaf_norms(tensors: Weights) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in tensors.items()}


def run_steps(spec: Spec, weights: Weights, batches: List[Dict], opt: Dict,
              precision: str = "float32") -> Dict:
    """The reference's first ``len(batches)`` steps from ``weights`` (float32
    tensors holding the drawn values; updated in place).  Returns the
    step losses, the first gradient's leaf norms as AdamW takes it
    (clipped; from the first moment), and the leaf norms of the weights'
    change over all steps."""
    with _no_tf32():
        start = {n: t.clone() for n, t in weights.items()}
        for t in weights.values():
            t.requires_grad_(True)
        ref = Reference(spec, weights, precision)
        stated = stated_dtype(spec)
        mu = {n: torch.zeros_like(t) for n, t in weights.items()}
        nu = {n: torch.zeros_like(t) for n, t in weights.items()}
        losses, first = [], None
        for i, batch in enumerate(batches):
            loss, grads = ref.loss_and_grads(batch)
            losses.append(loss)
            adamw(weights, grads, mu, nu, i + 1, opt, stated)
            del grads
            if i == 0:
                first = {n: v / (1 - opt["b1"])
                         for n, v in leaf_norms(mu).items()}
        change = {n: float((weights[n].detach() - start[n]).norm())
                  for n in weights}
    return {"losses": losses, "first_grad": first, "change": change}


class _no_tf32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)
