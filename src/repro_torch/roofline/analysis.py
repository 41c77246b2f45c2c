"""Roofline cost model: the analytic three-term step time on the H100.

The port's copy of the cost-model part of ``repro/roofline/analysis.py``
(``Costs``, the parameter and FLOP counts, ``step_costs``), with the
reference's TPU constants replaced by the H100's.  Per (arch x shape x
mesh) it counts a step's FLOPs, HBM bytes and collective bytes, and
:meth:`Costs.terms` turns them into seconds on ``chips`` cards:

    compute    = FLOPs / (chips * 989.4e12 dense BF16 FLOP/s)
    memory     = HBM bytes / (chips * 3.35e12 B/s)
    collective = collective bytes / (chips * 450e9 B/s NVLink per direction)

The counts depend only on the configuration and the mesh; only
:meth:`Costs.terms` reads the card's constants.  The fleet runtime
(:func:`repro_torch.runtime.fleet.estimate_duration`) prices every job
with it.  :func:`parse_collectives` is the reference's text parse of
compiled HLO (result bytes of every collective, by kind), copied as it
is; the port compiles no HLO, so its dry-run
(:mod:`repro_torch.launch.dryrun`) records the analytic collective
bytes instead.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

# --- NVIDIA H100 SXM5 80GB HBM3 constants (per card; the H100 datasheet,
# at the SXM5 part's 700 W) -------------------------------------------------
PEAK_FLOPS = 989.4e12      # dense BF16, tensor cores, no sparsity
HBM_BW = 3.35e12           # bytes/s, HBM3
NVLINK_BW = 450e9          # bytes/s per direction (NVLink 4, 18 links)
BYTES_PER_PARAM = 2        # bf16


@dataclasses.dataclass
class Costs:
    """Whole-step costs (global, not per card)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_intra_bytes: float = 0.0   # within a pod (NVLink)
    coll_inter_bytes: float = 0.0   # across pods (inter-node links)
    n_params: float = 0.0
    n_active_params: float = 0.0
    model_flops: float = 0.0        # 6*N*D (6*N_active*D for MoE)

    def terms(self, chips: int) -> Dict[str, float]:
        # inter-node links are far scarcer than NVLink; model them as a
        # quarter of NVLink per card, as the reference models its
        # inter-pod links against its intra-pod ones
        t_comp = self.flops / (chips * PEAK_FLOPS)
        t_mem = self.hbm_bytes / (chips * HBM_BW)
        t_coll = (self.coll_intra_bytes / (chips * NVLINK_BW)
                  + self.coll_inter_bytes / (chips * NVLINK_BW / 4))
        dom = max(("compute", t_comp), ("memory", t_mem),
                  ("collective", t_coll), key=lambda kv: kv[1])[0]
        return {"compute_s": t_comp, "memory_s": t_mem,
                "collective_s": t_coll, "dominant": dom,
                "useful_ratio": (self.model_flops / self.flops
                                 if self.flops else 0.0)}


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active-per-token) parameter counts."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (hq + 2 * hkv) + hq * hd * d
    mlp = 3 * d * f
    total = active = 0.0
    fam = cfg.family
    if fam in ("dense",):
        per_layer = attn + mlp
        total = active = cfg.n_layers * per_layer
    elif fam == "moe":
        router = d * cfg.n_experts
        expert = 3 * d * f
        per_layer = attn + router + cfg.n_experts * expert
        per_layer_active = attn + router + cfg.top_k * expert
        total = cfg.n_layers * per_layer
        active = cfg.n_layers * per_layer_active
    elif fam == "hybrid":
        total = active = cfg.n_layers * _mamba_params(cfg) + attn + mlp
    elif fam == "ssm":
        n_s, _ = _xlstm_split(cfg)
        total = active = ((cfg.n_layers - n_s) * _mlstm_params(cfg)
                          + n_s * _slstm_params(cfg))
    elif fam == "encdec":
        cross = attn + mlp
        total = active = (cfg.n_enc_layers * (attn + mlp)
                          + cfg.n_layers * (attn + mlp + cross)
                          + d * d)
    elif fam == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        total = active = (cfg.n_layers * (attn + mlp)
                          + n_cross * (attn + mlp)
                          + cfg.vision_dim * d)
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def _mamba_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    return (d * (2 * di + 2 * n + h) + cfg.conv_width * (di + 2 * n)
            + di * d + di)


def _mlstm_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    return d * 3 * d + 2 * d * cfg.n_heads + 2 * d * d


def _slstm_params(cfg: ModelConfig) -> float:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return 4 * d * d + h * hd * 4 * hd + d * d


def _xlstm_split(cfg: ModelConfig) -> Tuple[int, int]:
    every = cfg.slstm_every or (cfg.n_layers + 1)
    n_s = cfg.n_layers // every
    return n_s, every - 1


# ---------------------------------------------------------------------------
# FLOPs (forward, per *token*; attention terms take the context length)
# ---------------------------------------------------------------------------

def _attn_flops_token(cfg: ModelConfig, ctx: float) -> float:
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * hd * (hq + 2 * hkv) + 2 * hq * hd * d
    sdpa = 4 * hq * hd * ctx
    return proj + sdpa


def _mlp_flops_token(cfg: ModelConfig) -> float:
    return 6 * cfg.d_model * cfg.d_ff


def _moe_flops_token(cfg: ModelConfig) -> float:
    router = 2 * cfg.d_model * cfg.n_experts
    experts = (6 * cfg.d_model * cfg.d_ff * cfg.top_k
               * cfg.capacity_factor)
    return router + experts


def _mamba_flops_token(cfg: ModelConfig, chunk: float) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d
    conv = 2 * cfg.conv_width * (di + 2 * n)
    intra = 2 * chunk * n + 2 * chunk * di       # cb + weighted sum
    inter = 4 * di * n                           # y_inter + state update
    return proj + conv + intra + inter


def _mlstm_flops_token(cfg: ModelConfig, chunk: float) -> float:
    d = cfg.d_model
    hd = d // cfg.n_heads
    proj = 2 * d * 3 * d + 4 * d * d             # qkv + gate + out
    intra = 4 * chunk * d
    inter = 4 * d * hd
    return proj + intra + inter


def _slstm_flops_token(cfg: ModelConfig) -> float:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return 8 * d * d + 2 * h * hd * 4 * hd + 2 * d * d


def forward_flops(cfg: ModelConfig, n_tokens: float, ctx: float,
                  mode: str) -> float:
    """Forward FLOPs for ``n_tokens`` each attending over ``ctx``."""
    fam = cfg.family
    d = cfg.d_model
    win_ctx = min(ctx, cfg.window) if cfg.long_attention == "window" \
        else ctx
    chunk = min(256.0, max(ctx, 1.0))
    per_tok = 0.0
    if fam in ("dense", "moe"):
        layer = _attn_flops_token(cfg, ctx) + (
            _moe_flops_token(cfg) if fam == "moe"
            else _mlp_flops_token(cfg))
        per_tok = cfg.n_layers * layer
    elif fam == "hybrid":
        n_apps = -(-cfg.n_layers // cfg.attn_every)
        per_tok = (cfg.n_layers * _mamba_flops_token(cfg, chunk)
                   + n_apps * (_attn_flops_token(cfg, win_ctx)
                               + _mlp_flops_token(cfg)))
    elif fam == "ssm":
        n_s, _ = _xlstm_split(cfg)
        per_tok = ((cfg.n_layers - n_s) * _mlstm_flops_token(cfg, chunk)
                   + n_s * _slstm_flops_token(cfg))
    elif fam == "encdec":
        enc_tokens = cfg.enc_seq
        enc = cfg.n_enc_layers * (_attn_flops_token(cfg, enc_tokens)
                                  + _mlp_flops_token(cfg))
        cross_kv = (2 * 2 * cfg.n_kv_heads * cfg.hd * d * enc_tokens
                    * cfg.n_layers)
        cross_tok = (2 * d * cfg.n_heads * cfg.hd
                     + 4 * cfg.n_heads * cfg.hd * enc_tokens
                     + 2 * cfg.n_heads * cfg.hd * d
                     + _mlp_flops_token(cfg))
        dec = cfg.n_layers * (_attn_flops_token(cfg, ctx)
                              + _mlp_flops_token(cfg) + cross_tok)
        return (n_tokens * dec + enc * enc_tokens + cross_kv
                + n_tokens * 2 * d * cfg.vocab)
    elif fam == "vlm":
        src = cfg.vision_tokens
        n_cross = cfg.n_layers // cfg.cross_attn_every
        cross_kv = 2 * 2 * cfg.n_kv_heads * cfg.hd * d * src * n_cross
        cross_tok = (2 * d * cfg.n_heads * cfg.hd
                     + 4 * cfg.n_heads * cfg.hd * src
                     + 2 * cfg.n_heads * cfg.hd * d
                     + _mlp_flops_token(cfg))
        per_tok = (cfg.n_layers * (_attn_flops_token(cfg, ctx)
                                   + _mlp_flops_token(cfg))
                   + n_cross * cross_tok)
        return (n_tokens * per_tok + cross_kv
                + n_tokens * 2 * d * cfg.vocab)
    logits = 2 * d * cfg.vocab
    return n_tokens * (per_tok + logits)


# ---------------------------------------------------------------------------
# whole-step cost model
# ---------------------------------------------------------------------------

def step_costs(cfg: ModelConfig, shape: ShapeConfig,
               mesh_shape: Dict[str, int],
               microbatches: int = 1,
               opt_state_bytes_per_param: int = 8) -> Costs:
    n_total, n_active = param_count(cfg)
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    pods = mesh_shape.get("pod", 1)
    c = Costs(n_params=n_total, n_active_params=n_active)
    d = cfg.d_model
    act_bytes = 2  # bf16

    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        # executed attention context: the plain-SDPA path (T <= 8192)
        # runs the full masked T x T matmul; the blockwise path skips
        # future KV blocks, approaching the causal T/2 average.
        ctx = shape.seq_len if shape.seq_len <= 8192 \
            else shape.seq_len / 2
        fwd = forward_flops(cfg, toks, ctx, "train")
        c.flops = 3 * fwd                 # fwd + 2x bwd
        c.model_flops = 6 * n_active * toks
        # HBM: params/grads/opt traffic + rematerialised activations
        param_traffic = (3 * n_total * BYTES_PER_PARAM           # read f+b, write
                         + 2 * n_total * 4                        # grad rw (f32)
                         + 2 * n_total * opt_state_bytes_per_param)
        layer_act = toks * d * act_bytes
        n_lay = cfg.n_layers + getattr(cfg, "n_enc_layers", 0)
        act_traffic = 6 * n_lay * layer_act   # save+reload+recompute
        c.hbm_bytes = param_traffic + act_traffic
        # collectives: DP grad reduce + ZeRO gather + TP activation
        ring = 2 * (dp - 1) / dp if dp > 1 else 0.0
        grad_bytes = n_total * BYTES_PER_PARAM * ring
        tp_ring = 2 * (tp - 1) / tp if tp > 1 else 0.0
        # 2 all-reduces per layer (attn out + mlp out) on [B,T,d];
        # under sequence parallelism the psum lowers to reduce-scatter
        # + all-gather: half the ring bytes.
        sp = 0.5 if cfg.seq_parallel else 1.0
        tp_bytes = 2 * n_lay * toks * d * act_bytes * tp_ring * sp
        if cfg.family == "moe":
            # EP all-to-all: dispatch+combine, 2x each way; int8
            # payloads (+ bf16 scales) cut bytes to ~0.53x.
            a2a_scale = (0.5 + 1.0 / d) if cfg.moe_quant_dispatch \
                else 1.0
            tp_bytes += 4 * cfg.n_layers * toks * cfg.top_k * d \
                * act_bytes / tp * a2a_scale
        inter_frac = (pods - 1) / pods if pods > 1 else 0.0
        c.coll_inter_bytes = grad_bytes * inter_frac
        c.coll_intra_bytes = grad_bytes * (1 - inter_frac) + tp_bytes
    elif shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        ctx = shape.seq_len if shape.seq_len <= 8192 \
            else shape.seq_len / 2
        c.flops = forward_flops(cfg, toks, ctx, "prefill")
        c.model_flops = 2 * n_active * toks
        c.hbm_bytes = (n_total * BYTES_PER_PARAM
                       + 8 * (cfg.n_layers
                              + getattr(cfg, "n_enc_layers", 0))
                       * toks * d * act_bytes)
        tp_ring = 2 * (tp - 1) / tp if tp > 1 else 0.0
        c.coll_intra_bytes = 2 * cfg.n_layers * toks * d * act_bytes \
            * tp_ring
    else:  # decode: one token per sequence against ctx
        toks = shape.global_batch
        ctx = shape.seq_len
        c.flops = forward_flops(cfg, toks, ctx, "decode")
        c.model_flops = 2 * n_active * toks
        cache = _decode_cache_bytes(cfg, shape)
        c.hbm_bytes = n_total * BYTES_PER_PARAM + cache
        tp_ring = 2 * (tp - 1) / tp if tp > 1 else 0.0
        c.coll_intra_bytes = 2 * cfg.n_layers * toks * d * act_bytes \
            * tp_ring
    return c


def _decode_cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Bytes read from the KV cache / recurrent state per decode step."""
    b, s = shape.global_batch, shape.seq_len
    eff = min(s, cfg.window) if cfg.long_attention == "window" else s
    fam = cfg.family
    kv_bytes = (1.0 + 2.0 / cfg.hd) if cfg.kv_cache_dtype == "int8" \
        else BYTES_PER_PARAM
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * kv_bytes
    if fam in ("dense", "moe", "vlm", "encdec"):
        n_l = cfg.n_layers
        extra = 0.0
        if fam == "vlm":
            extra = (cfg.n_layers // cfg.cross_attn_every) * \
                cfg.vision_tokens * kv_row * b
        if fam == "encdec":
            extra = cfg.n_layers * cfg.enc_seq * kv_row * b
        return n_l * b * eff * kv_row + extra
    if fam == "hybrid":
        n_apps = -(-cfg.n_layers // cfg.attn_every)
        di = cfg.ssm_expand * cfg.d_model
        h = di // cfg.ssm_head_dim
        ssm_state = cfg.n_layers * b * h * cfg.ssm_head_dim \
            * cfg.ssm_state * 4
        return n_apps * b * min(eff, cfg.window) * kv_row + 2 * ssm_state
    if fam == "ssm":
        n_s, _ = _xlstm_split(cfg)
        hd = cfg.d_model // cfg.n_heads
        m_state = (cfg.n_layers - n_s) * b * cfg.n_heads * hd * hd * 4
        s_state = n_s * b * cfg.d_model * 4 * 4
        return 2 * (m_state + s_state)
    return 0.0


# ---------------------------------------------------------------------------
# compiled-HLO collective extraction
# ---------------------------------------------------------------------------

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|s32|u64|u32|s8|u8|pred)"
                       r"\[([0-9,]*)\]")
_DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4,
                "u32": 4, "bf16": 2, "f16": 2, "s8": 1, "u8": 1,
                "pred": 1}
_COLL_RE = re.compile(
    r"^\s*(?:%\S+\s*=\s*)?(\([^)]*\)|\S+)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(", re.M)


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for x in dims.split(","):
            if x:
                n *= int(x)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> Dict[str, float]:
    """Sum result-shape bytes of every collective op, by op kind.

    NOTE: ops inside ``while`` bodies are counted once (XLA prints the
    body once); the analytic model is authoritative for loop-carried
    collectives and this parse is the structural cross-check.
    """
    out: Dict[str, float] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_txt, kind = m.group(1), m.group(2)
        out[kind] = out.get(kind, 0.0) + _shape_bytes(shape_txt)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out
