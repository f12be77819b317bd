"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch
(answers `src/repro/models/moe.py`, whole).

Routing is computed within fixed-size token *groups* (default 512
tokens): a softmax router in f32, the top-k experts with their gates
renormalised, and each (token, k) decision's position in its expert's
queue by a cumsum over the group's token-major (T·K) order. Decisions
past the expert's capacity are dropped. The reference dispatches and
combines with one-hot einsums; here the kept decisions are scattered
into the (G, X, C, E) expert slots and gathered back, which moves the
same rows: a slot receives one token or none, so the scatter equals the
reference's 0/1 product exactly. The keep/drop decisions and the slots
are the reference's, ties in the router included (a stable sort keeps
the lower expert index first, as `lax.top_k` does).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import Params, einsum32, mlp_apply, mlp_init
from repro_torch.sharding.axes import ParamBuilder, constrain

F32 = torch.float32


def moe_init(b: ParamBuilder, name: str, cfg: ModelConfig,
             mcfg: MoEConfig) -> Params:
    d = cfg.d_model
    de = mcfg.d_expert or cfg.d_ff
    x = mcfg.num_experts
    p = dict(
        router=b.param(f"{name}/router", (d, x), ("embed", None),
                       scale=0.02, dtype="float32"),
        w_gate=b.param(f"{name}/w_gate", (x, d, de),
                       ("experts", "expert_embed", "expert_mlp")),
        w_up=b.param(f"{name}/w_up", (x, d, de),
                     ("experts", "expert_embed", "expert_mlp")),
        w_down=b.param(f"{name}/w_down", (x, de, d),
                       ("experts", "expert_mlp", "expert_embed"),
                       scale=1.0 / math.sqrt(de)))
    if mcfg.num_shared_experts:
        p["shared"] = mlp_init(b, f"{name}/shared", d,
                               mcfg.num_shared_experts * de)
    return Params(**p)


class _GradBf16(torch.autograd.Function):
    """Identity whose backward casts the cotangent to bf16: under
    token_exchange it keeps the expert block's backward partial sums in
    bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def _grad_bf16(x: torch.Tensor) -> torch.Tensor:
    return _GradBf16.apply(x)


def _capacity(group: int, mcfg: MoEConfig) -> int:
    c = int(math.ceil(mcfg.capacity_factor * group * mcfg.top_k
                      / mcfg.num_experts))
    return max(4, min(c, group))


def _top_k(probs: torch.Tensor, k: int):
    """(gates, idx) of the k largest along the last dim, exact ties in
    index order (lower first) as lax.top_k returns them."""
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gates[..., :k], idx[..., :k]


def _route(params, xg: torch.Tensor, mcfg: MoEConfig, cap: int):
    """Router decisions of (G,T,E) groups: logits (G,T,X) f32, probs,
    gates (G,T,K), expert ids (G,T,K), slot in the expert's queue
    (G,T,K) and keep (G,T,K)."""
    nx, k = mcfg.num_experts, mcfg.top_k
    ng, g_t = xg.shape[:2]
    logits = einsum32("gte,ex->gtx", xg, params["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, nx).to(F32)                # (G,T,K,X)
    flat = onehot.reshape(ng, g_t * k, nx)
    # position of each (token, k) decision within its expert's queue
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(ng, g_t, k, nx)
    slot = (pos * onehot).sum(-1).long()               # (G,T,K)
    keep = ((pos < cap) & (onehot > 0)).any(-1)        # (G,T,K)
    return logits, probs, onehot, gates, idx, slot, keep


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, mcfg: MoEConfig,
              group_size: int = 512, mesh=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,E) → (B,S,E), aux-loss dict."""
    dt = x.dtype
    bsz, seq, d = x.shape
    tokens = bsz * seq
    g_t = min(group_size, tokens)
    pad = (-tokens) % g_t
    xf = x.reshape(tokens, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    ng = xf.shape[0] // g_t
    xg = xf.reshape(ng, g_t, d)                        # (G,T,E)
    nx, k = mcfg.num_experts, mcfg.top_k
    cap = _capacity(g_t, mcfg)
    logits, probs, onehot, gates, idx, slot, keep = _route(params, xg, mcfg,
                                                           cap)

    # dispatch: each kept decision's token row into its (expert, slot)
    # row of the flattened (G·X·C, E) slots (a dropped one points at
    # slot 0 and is masked out)
    g_ix = torch.arange(ng, device=x.device)[:, None, None]
    t_ix = torch.arange(g_t, device=x.device)[None, :, None]
    row_of = (g_ix * nx + idx) * cap + torch.where(keep, slot, 0)
    src = xg[g_ix.expand_as(idx)[keep], t_ix.expand_as(idx)[keep]]
    xs = torch.zeros((ng * nx * cap, d), dtype=dt, device=x.device)
    xs[row_of[keep]] = src
    xs = xs.reshape(ng, nx, cap, d)                    # (G,X,C,E)
    if mcfg.token_exchange:
        xs = constrain(xs, mesh, None, "act_experts", None,
                       "act_expert_embed")
    h_gate = einsum32("gxce,xef->gxcf", xs, params["w_gate"])
    h_up = einsum32("gxce,xef->gxcf", xs, params["w_up"])
    h = (F.silu(h_gate) * h_up).to(dt)
    ys = einsum32("gxcf,xfe->gxce", h, params["w_down"]).to(dt)  # (G,X,C,E)
    if mcfg.token_exchange:
        ys = constrain(ys, mesh, None, "act_experts", None,
                       "act_expert_embed")
    # combine: each decision's expert output, weighted by its gate (in
    # the compute dtype, as the reference's combine tensor), dropped → 0
    rows = ys.reshape(ng * nx * cap, d)[row_of]              # (G,T,K,E)
    wgt = torch.where(keep, gates, 0.0).to(dt).to(F32)
    out = (rows.to(F32) * wgt[..., None]).sum(2).to(dt)     # (G,T,E)
    if mcfg.token_exchange:
        out = _grad_bf16(out)

    out = out.reshape(-1, d)[:tokens].reshape(bsz, seq, d)
    if mcfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], x)

    # aux losses (Switch-style load balance + router z-loss)
    density = onehot.sum(2).mean(1)                    # (G,X)
    mean_prob = probs.mean(1)                          # (G,X)
    lb = nx * (density * mean_prob).sum(-1).mean() / k
    z = torch.logsumexp(logits, dim=-1).square().mean()
    aux = {
        "moe_load_balance": lb.to(F32),
        "moe_router_z": z.to(F32),
        "moe_drop_fraction": 1.0 - keep.to(F32).mean(),
    }
    return out, aux


def moe_dense_reference(params, x: torch.Tensor, cfg: ModelConfig,
                        mcfg: MoEConfig) -> torch.Tensor:
    """Oracle: evaluate EVERY expert densely, combine with top-k gates.
    O(X·T) compute — only for tests (validates routing & dispatch)."""
    dt = x.dtype
    logits = einsum32("bse,ex->bsx", x, params["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, mcfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    gate_full = (F.one_hot(idx, mcfg.num_experts).to(F32)
                 * gates[..., None]).sum(-2)           # (B,S,X)
    hg = einsum32("bse,xef->bsxf", x, params["w_gate"])
    hu = einsum32("bse,xef->bsxf", x, params["w_up"])
    h = (F.silu(hg) * hu).to(dt)
    y = einsum32("bsxf,xfe->bsxe", h, params["w_down"])
    out = torch.einsum("bsxe,bsx->bse", y, gate_full).to(dt)
    if mcfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], x)
    return out
