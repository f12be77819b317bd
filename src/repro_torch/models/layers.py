"""Shared transformer layers: norms, RoPE, GQA attention (full / sliding
window / decode-with-cache), SwiGLU MLP, embeddings (answers
`src/repro/models/layers.py`, whole).

Every product accumulates in float32, as the reference's
``preferred_element_type=F32`` asks: the operands are widened to f32
before the product (a product of two bf16 or f32 values is exact in
f32), so a bf16 model's products are never rounded to bf16 on the way.
The reference's einsums promote a bf16 activation against an f32
parameter to f32, so the parameters are read in f32 here too, except
where the reference casts them (embedding, LM head, biases). The callers
keep TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`, the
default, and float32 matmul precision 'highest').

Attention over long sequences is the reference's flash-style chunked
form: an online softmax over key chunks per query chunk, the causal and
sliding-window key range bounded statically per query chunk, masked
scores set to ``NEG_INF``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.axes import ParamBuilder

F32 = torch.float32
NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Params(nn.Module):
    """One node of the parameter tree, read like the reference's dicts:
    ``p["wq"]``, ``"attn" in p``. Tensors become parameters that take
    gradients (the trainer's autograd reads them; serving runs under
    ``torch.inference_mode()`` and records nothing), modules become
    children."""

    def __init__(self, **entries):
        super().__init__()
        for name, v in entries.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=True))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def with_children(self, kids: dict) -> "Params":
        """A new node of this one's names holding ``kids``."""
        return Params(**kids)


class LayerStack(nn.ModuleList):
    """The layers in order, one `Params` a layer. ``period`` is the
    reference's stacking: it keeps layer r·P + i as entry r of
    ``blocks/pos{i}`` (a leading repeats axis, `_Stacked`), which the
    optimizers and the converters follow."""

    def __init__(self, layers=(), period: int = 1):
        super().__init__(layers)
        self.period = period

    def with_children(self, kids: dict) -> "LayerStack":
        return LayerStack([kids[str(i)] for i in range(len(kids))],
                          self.period)


def einsum32(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """einsum with float32 accumulation: every operand widened to f32."""
    return torch.einsum(eq, *(x.to(F32) for x in xs))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(b: ParamBuilder, name: str, dim: int) -> Params:
    return Params(scale=b.param(f"{name}/scale", (dim,), ("norm",),
                               init="ones"))


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE (split-half convention, angles in f32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].to(F32) * freqs       # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention params
# ---------------------------------------------------------------------------


def attention_init(b: ParamBuilder, name: str,
                   cfg: ModelConfig) -> Params:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": b.param(f"{name}/wq", (d, h, hd),
                      ("embed", "heads", "head_dim")),
        "wk": b.param(f"{name}/wk", (d, kv, hd),
                      ("embed", "kv_heads", "head_dim")),
        "wv": b.param(f"{name}/wv", (d, kv, hd),
                      ("embed", "kv_heads", "head_dim")),
        "wo": b.param(f"{name}/wo", (h, hd, d), ("heads", "head_dim", "embed"),
                      scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = b.param(f"{name}/bq", (h, hd), ("heads", "head_dim"),
                          init="zeros")
        p["bk"] = b.param(f"{name}/bk", (kv, hd), ("kv_heads", "head_dim"),
                          init="zeros")
        p["bv"] = b.param(f"{name}/bv", (kv, hd), ("kv_heads", "head_dim"),
                          init="zeros")
    return Params(**p)


def qkv_project(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,E) → q:(B,S,H,D), k/v:(B,S,Kv,D) with RoPE applied."""
    dt = x.dtype
    q = einsum32("bse,ehd->bshd", x, params["wq"]).to(dt)
    k = einsum32("bse,ehd->bshd", x, params["wk"]).to(dt)
    v = einsum32("bse,ehd->bshd", x, params["wv"]).to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(params, attn: torch.Tensor) -> torch.Tensor:
    return einsum32("bshd,hde->bse", attn, params["wo"]).to(attn.dtype)


# ---------------------------------------------------------------------------
# Flash-style chunked attention (training / prefill)
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q:(B,Sq,H,D) k:(B,Sk,Kv,D) → (B,Kv,G,Sq,Sk) fp32, G = H//Kv."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    return einsum32("bskgd,btkd->bkgst", qg, k) / math.sqrt(d)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """probs:(B,Kv,G,Sq,Sk) v:(B,Sk,Kv,D) → (B,Sq,H,D)."""
    b, kvh, g, sq, sk = probs.shape
    o = einsum32("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return o.reshape(b, sq, kvh * g, -1).to(out_dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention, O(chunk²) memory.

    q: (B,Sq,H,D); k,v: (B,Sk,Kv,D). ``window``>0 applies sliding-window
    masking (key position > query position - window). ``q_offset`` is the
    absolute position of q[0] relative to k[0] (for prefill Sq == Sk → 0).
    Causal and sliding-window attention visit only the key chunks that
    can hold an unmasked key: SWA does O(S·W) work, not O(S²).
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"sequence lengths ({sq}, {sk}) must be multiples "
                         f"of the chunks ({q_chunk}, {kv_chunk})")
    nq, nk = sq // q_chunk, sk // kv_chunk
    kvh = k.shape[2]
    g = h // kvh
    dev = q.device
    q_pos_base = torch.arange(q_chunk, device=dev) + q_offset
    k_pos_base = torch.arange(kv_chunk, device=dev)

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=F32, device=dev)
        lo, hi = 0, nk - 1
        if causal or window > 0:
            q_lo = qi * q_chunk + q_offset
            q_hi = q_lo + q_chunk - 1
            if causal:
                hi = min(nk - 1, q_hi // kv_chunk)
            if window > 0:
                lo = max(0, (q_lo - window + 1) // kv_chunk)
        qpos = q_pos_base + qi * q_chunk
        for ki in range(lo, hi + 1):
            kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = _gqa_scores(qc, kc)                    # (B,Kv,G,qc,kc) f32
            kpos = k_pos_base + ki * kv_chunk
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(-1)
            pv = einsum32("bkgst,btkd->bkgsd", p.to(v.dtype), vc)
            acc = acc * scale[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-37)
        outs.append(out.reshape(b, kvh * g, q_chunk, d).transpose(1, 2))
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-step decode: q (B,1,H,D) over cache (B,T,Kv,D);
    ``valid_mask`` (B,T) marks filled cache slots."""
    s = _gqa_scores(q, k_cache)                        # (B,Kv,G,1,T) f32
    s = torch.where(valid_mask[:, None, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    probs = p / torch.clamp(l, min=1e-37)
    return _gqa_out(probs, v_cache, q.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(b: ParamBuilder, name: str, d_model: int,
             d_ff: int) -> Params:
    return Params(
        wi_gate=b.param(f"{name}/wi_gate", (d_model, d_ff), ("embed", "mlp")),
        wi_up=b.param(f"{name}/wi_up", (d_model, d_ff), ("embed", "mlp")),
        wo=b.param(f"{name}/wo", (d_ff, d_model), ("mlp", "embed"),
                   scale=1.0 / math.sqrt(d_ff)))


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = einsum32("bse,ef->bsf", x, params["wi_gate"])
    up = einsum32("bse,ef->bsf", x, params["wi_up"])
    h = (F.silu(gate) * up).to(dt)
    return einsum32("bsf,fe->bse", h, params["wo"]).to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embedding_init(b: ParamBuilder, cfg: ModelConfig) -> Params:
    p = {"tok": b.param("embed/tok", (cfg.vocab_size, cfg.d_model),
                        ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = b.param("embed/head", (cfg.d_model, cfg.vocab_size),
                            ("embed", "vocab"),
                            scale=1.0 / math.sqrt(cfg.d_model))
    return Params(**p)


def embed_tokens(params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """A gather of the rows (cast to the compute dtype), no scale.
    `F.embedding`'s backward sums each row's gradients in a fixed order
    on the card, so a train step is a pure function of its state and
    batch (a resumed run equals an unbroken one bit for bit)."""
    return F.embedding(tokens, params["tok"]).to(dtype_of(cfg))


def lm_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,E) → (B,S,V) fp32 logits."""
    if cfg.tie_embeddings:
        return einsum32("bse,ve->bsv", x, params["tok"].to(x.dtype))
    return einsum32("bse,ev->bsv", x, params["head"].to(x.dtype))


class _TakeLabel(torch.autograd.Function):
    """logits[..., label]: the reference's one-hot product, as a gather
    whose backward writes each row's one entry (``scatter_``, no
    accumulation: one index a row). Gather's own backward adds with
    atomics on the card, in no fixed order."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(labels)
        ctx.meta = (logits.shape, logits.dtype)
        return logits.gather(-1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        labels, = ctx.saved_tensors
        shape, dtype = ctx.meta
        out = torch.zeros(shape, dtype=dtype, device=g.device)
        return out.scatter_(-1, labels[..., None],
                            g[..., None].to(dtype)), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean next-token CE. logits (B,S,V) fp32, labels (B,S) int."""
    lse = torch.logsumexp(logits, dim=-1)              # (B,S)
    label_logit = _TakeLabel.apply(logits, labels.long())
    nll = lse - label_logit
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
