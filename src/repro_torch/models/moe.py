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
from repro_torch.models.layers import (Params, einsum32, from_shard,
                                       gather_fsdp, local_einsum, mlp_apply,
                                       mlp_init)
from repro_torch.sharding.axes import ParamBuilder, constrain, is_dtensor

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
    bf16. Over a mesh a cotangent that is a partial sum is reduced
    first: the sum is rounded, as on one device, not each rank's part."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and any(p.is_partial() for p in g.placements):
            from torch.distributed.tensor import Replicate
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_partial() else p for p in g.placements])
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


def _group_layout(x, g_t: int):
    """(mesh, batch dims, placements) of DTensor `x` for the routing:
    its rows stay split on the mesh dims that split its batch evenly
    (``Shard(0)``), whole elsewhere, when each rank's tokens make whole
    groups of `g_t`; otherwise no dim splits them (every rank routes
    every group). A plain `x`: (None, [], None)."""
    if not is_dtensor(x):
        return None, [], None
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    bdims = [d for d, p in enumerate(x.placements) if type(p) is Shard
             and p.dim == 0]
    ranks = math.prod(mesh.size(d) for d in bdims)
    bsz, seq = x.shape[:2]
    if bsz % ranks or (bsz // ranks * seq) % g_t:
        bdims = []
    return mesh, bdims, [Shard(0) if d in bdims else Replicate()
                         for d in range(mesh.ndim)]


def _local_param(w, mesh, bdims):
    """Parameter `w` whole on this rank, its gradient a partial sum over
    the batch dims (each rank routes its own groups)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Partial, Replicate
    rep = [Replicate()] * mesh.ndim
    if list(w.placements) != rep:
        w = w.redistribute(mesh, rep)
    return w.to_local(grad_placements=[Partial() if d in bdims
                                       else Replicate()
                                       for d in range(mesh.ndim)])


def _partial_grad(t, mesh, want, grads):
    """`t` (laid out as ``want``) itself, its gradient read as ``grads``:
    a partial sum over the expert dims, where each rank combines only
    its own experts' rows, reduced to ``want`` there."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, want, run_check=False).to_local(
        grad_placements=grads)


def _slots_dtensor(xs, mesh, want, shape):
    """The rank's (G_local, X, C, E) slots as a DTensor of the (G, X, C,
    E) slots: its groups split on the batch dims."""
    return from_shard(xs, mesh, want, shape)


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, mcfg: MoEConfig,
              group_size: int = 512, mesh=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,E) → (B,S,E), aux-loss dict. Over a mesh (DTensor `x`)
    each rank routes, dispatches and combines its own rows' groups, as
    XLA partitions the reference's one-hot einsums by group: the groups
    are the reference's (``g_t`` of the GLOBAL token count), so a rank's
    decisions equal the one-device ones for its groups. Its slots are a
    DTensor split on the batch dims; the expert products run on it, the
    experts split on "model" (weights gathered over their FSDP dims at
    use, `_expert_einsum`), or under token_exchange the slots redistributed to the
    embed split of the weights (the all-to-all) and the embed contracted
    into partial sums in the compute dtype. The combine reads each rank's
    own groups' rows of its own experts, a partial sum over the expert
    dims; the aux losses are means over every group. Where a rank's
    rows do not make whole groups (decode: one group of 128 tokens over
    the data ranks), every rank routes every group."""
    dt = x.dtype
    bsz, seq, d = x.shape
    tokens = bsz * seq
    g_t = min(group_size, tokens)
    mesh_, bdims, want = _group_layout(x, g_t)
    xl = x
    if mesh_ is not None:
        if list(x.placements) != want:
            x = x.redistribute(mesh_, want)
        xl = x.to_local()
    rows_l = xl.shape[0]
    xf = xl.reshape(rows_l * seq, d)
    pad = (-xf.shape[0]) % g_t
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    ng_l = xf.shape[0] // g_t
    ng = ng_l * (bsz // rows_l)
    xg = xf.reshape(ng_l, g_t, d)                      # (G,T,E)
    nx, k = mcfg.num_experts, mcfg.top_k
    cap = _capacity(g_t, mcfg)
    logits, probs, onehot, gates, idx, slot, keep = _route(
        {"router": _local_param(params["router"], mesh_, bdims)}, xg,
        mcfg, cap)

    # dispatch: each kept decision's token row into its (expert, slot)
    # row of the flattened (G·X·C, E) slots; a dropped one is written to
    # one spare row past them, cut off after (no shape depends on the
    # data: the dry run traces this on meta tensors). The combine reads
    # a dropped decision at slot 0, masked out by its zero weight.
    g_ix = torch.arange(ng_l, device=xl.device)[:, None, None]
    t_ix = torch.arange(g_t, device=xl.device)[None, :, None]
    at = torch.where(keep, slot, 0)
    spare = ng_l * nx * cap
    src = xg[g_ix.expand_as(idx), t_ix.expand_as(idx)]  # (G,T,K,E)
    xs = torch.zeros((spare + 1, d), dtype=dt, device=xl.device)
    xs[torch.where(keep, (g_ix * nx + idx) * cap + at, spare)] = src
    xs = xs[:spare].reshape(ng_l, nx, cap, d)          # (G,X,C,E)
    if mesh_ is not None:
        xs = _slots_dtensor(xs, mesh_, want, (ng, nx, cap, d))
    if mcfg.token_exchange:
        xs = constrain(xs, mesh, None, "act_experts", None,
                       "act_expert_embed")
    prod = _exchange_einsum if mcfg.token_exchange else _expert_einsum
    h_gate = prod("gxce,xef->gxcf", xs, params["w_gate"])
    h_up = prod("gxce,xef->gxcf", xs, params["w_up"])
    h = (F.silu(h_gate) * h_up).to(dt)
    ys = prod("gxcf,xfe->gxce", h, params["w_down"]).to(dt)  # (G,X,C,E)
    if mcfg.token_exchange:
        ys = constrain(ys, mesh, None, "act_experts", None,
                       "act_expert_embed")

    # combine: each decision's expert output, weighted by its gate (in
    # the compute dtype, as the reference's combine tensor), dropped → 0;
    # over a mesh from this rank's experts' rows (a partial sum over the
    # dims that split the experts)
    x_lo, x_n, edims = 0, nx, []
    if mesh_ is not None:
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        edims = [e for e, p in enumerate(ys.placements)
                 if e not in bdims and p == Shard(1)]
        ys_want = [Shard(0) if e in bdims else (Shard(1) if e in edims
                                                else Replicate())
                   for e in range(mesh_.ndim)]
        if list(ys.placements) != ys_want:
            ys = ys.redistribute(mesh_, ys_want)
        shp, off = compute_local_shape_and_global_offset(
            ys.shape, mesh_, ys_want)
        x_lo, x_n = off[1], shp[1]
        ys = ys.to_local()
        if edims:
            gates = _partial_grad(gates, mesh_, want, [
                Partial() if e in edims else p for e, p in enumerate(want)])
    if x_n == nx:
        at_row = (g_ix * nx + idx) * cap + at
        wgt = torch.where(keep, gates, 0.0)
    else:
        le = idx - x_lo
        mine = (le >= 0) & (le < x_n)
        at_row = torch.where(mine, (g_ix * x_n + le) * cap + at, 0)
        wgt = torch.where(keep & mine, gates, 0.0)
    rows = ys.reshape(ng_l * x_n * cap, d)[at_row]     # (G,T,K,E)
    out = (rows.to(F32) * wgt.to(dt).to(F32)[..., None]).sum(2)  # (G,T,E)
    out = out.reshape(-1, d)[:rows_l * seq].reshape(rows_l, seq, d)
    if mesh_ is not None:
        if mcfg.token_exchange:
            out = out.to(dt)        # the partial sums reduced in dt
        out = from_shard(out, mesh_, [
            Partial() if e in edims else p for e, p in enumerate(want)],
            (bsz, seq, d))
        if edims:
            out = out.redistribute(mesh_, want)
    out = out.to(dt)
    if mcfg.token_exchange:
        out = _grad_bf16(out)

    if mcfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], x)

    # aux losses (Switch-style load balance + router z-loss): means over
    # every group
    density = onehot.sum(2).mean(1)                    # (G,X)
    mean_prob = probs.mean(1)                          # (G,X)
    per_group = (density * mean_prob).sum(-1)          # (G,)
    lse2 = torch.logsumexp(logits, dim=-1).square()    # (G,T)
    kept = keep.to(F32)                                # (G,T,K)
    if mesh_ is not None:
        per_group, lse2, kept = (
            from_shard(t, mesh_, want, (ng,) + tuple(t.shape[1:]))
            for t in (per_group, lse2, kept))
    aux = {
        "moe_load_balance": _whole(nx * per_group.mean() / k).to(F32),
        "moe_router_z": _whole(lse2.mean()).to(F32),
        "moe_drop_fraction": _whole(1.0 - kept.mean()),
    }
    return out, aux


def _expert_einsum(eq: str, a, w):
    """An expert product in f32. Over a mesh the weights are gathered over
    every FSDP dim, also where every rank routes every group and no
    activation is split on those dims, where `einsum32` would contract
    the weights' embed split into partial sums over the data ranks:
    those round the gradients further from the one-device step's than
    its yardstick rule allows (`test_torch_train_shard_models.py`'s MoE
    case, whose one group of 64 tokens every rank routes: the
    embedding's first moment at 2.63× the float32 yardstick's RMS error
    after step 2, past 2.5×)."""
    if not is_dtensor(a):
        return einsum32(eq, a, w)
    return local_einsum(eq, a.to(F32), gather_fsdp(w).to(F32))


def _exchange_einsum(eq: str, a, w):
    """A token-exchange product: over a mesh the weights keep their FSDP
    embed split (no gather), which the slots' embed split meets, so the
    contraction is a partial sum over those ranks, cast to the compute
    dtype before it is reduced (the reference's ``acc_t``)."""
    if not is_dtensor(a):
        return einsum32(eq, a, w)
    return local_einsum(eq, a.to(F32), w.to(F32)).to(a.dtype)


def _whole(t):
    """A DTensor scalar replicated on every rank; a plain one as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


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
