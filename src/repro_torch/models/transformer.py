"""Flexible decoder-only / encoder-decoder LM assembled from per-layer
mixer ∈ {attn, mamba2} and FFN ∈ {dense, moe, none} patterns (answers
`src/repro/models/transformer.py`, whole).

The reference stacks each period position's parameters over the
repeats for ``lax.scan``; here every layer is its own `Params` module in
a `LayerStack` (an ``nn.ModuleList`` that keeps the period, the
reference's stacking, for the optimizers and the converters) and the
blocks run in a Python loop, so layer l's structure is read from the
config at l (the same as at l mod period, since the period is a
multiple of every pattern's). The decode cache is per layer too:
``{"layers": [entry, …], "index": int}``.

Three entry points mirror the shape kinds:
  * ``loss_fn``      — full causal forward + CE
  * ``prefill``      — forward + KV/SSM cache capture, last-token logits
  * ``decode_step``  — one token against a cache

``remat`` maps the reference's ``jax.checkpoint`` of one repeat of the
period onto non-reentrant ``torch.utils.checkpoint`` over the same P
layers: ``"full"`` saves only the repeat's input; ``"block"`` (the
reference's ``dots_with_no_batch_dims_saveable``) also saves the
products without batch dimensions, the projections', which torch's
einsum runs as a bmm over a batch of 1, and recomputes the rest (the
attention's batched products, norms, activations); ``"none"`` saves
everything. The encoder's layers take a plain checkpoint each under
either. Without autograd (serving, prefill) nothing is wrapped. The
gradients do not depend on ``remat``: the recomputation repeats the
forward's operations on the same inputs.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X
from repro_torch.models.layers import LayerStack, Params, einsum32
from repro_torch.sharding.axes import (ParamBuilder, constrain,
                                       current_act_rules, is_dtensor,
                                       mesh_shape, placements, resolve_spec,
                                       unflatten_axes)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Period / pattern helpers
# ---------------------------------------------------------------------------


def period_of(cfg: ModelConfig) -> int:
    p = 1
    if cfg.ssm is not None and cfg.num_heads > 0:
        p = math.lcm(p, cfg.attn_every)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe_every)
    if cfg.sliding_window > 0 and cfg.swa_pattern > 1:
        p = math.lcm(p, cfg.swa_pattern)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"multiple of the layer pattern's period {p}")
    return p


def attn_chunk(seq: int) -> int:
    if seq <= 2048:
        return max(seq, 1)
    return 2048 if seq >= 16_384 else 1024


def _cache_len(cfg: ModelConfig, layer: int, max_len: int) -> int:
    if cfg.layer_is_swa(layer):
        return min(cfg.sliding_window, max_len)
    return max_len


# ---------------------------------------------------------------------------
# Parameter construction (one module a layer)
# ---------------------------------------------------------------------------


def _block_init(b: ParamBuilder, name: str, cfg: ModelConfig, layer: int,
                cross: bool) -> Params:
    p: Dict[str, Any] = {"norm1": L.rmsnorm_init(b, f"{name}/norm1",
                                                 cfg.d_model)}
    if cfg.mixer_kind(layer) == "attn":
        p["attn"] = L.attention_init(b, f"{name}/attn", cfg)
    else:
        p["mamba"] = M.mamba_init(b, f"{name}/mamba", cfg)
    if cross:
        p["norm_x"] = L.rmsnorm_init(b, f"{name}/norm_x", cfg.d_model)
        p["cross"] = L.attention_init(b, f"{name}/cross", cfg)
    fk = cfg.ffn_kind(layer)
    if fk != "none":
        p["norm2"] = L.rmsnorm_init(b, f"{name}/norm2", cfg.d_model)
        if fk == "dense":
            p["mlp"] = L.mlp_init(b, f"{name}/mlp", cfg.d_model, cfg.d_ff)
        else:
            p["moe"] = X.moe_init(b, f"{name}/moe", cfg, cfg.moe)
    return Params(**p)


def _enc_block_init(b: ParamBuilder, name: str, cfg: ModelConfig) -> Params:
    return Params(
        norm1=L.rmsnorm_init(b, f"{name}/norm1", cfg.d_model),
        attn=L.attention_init(b, f"{name}/attn", cfg),
        norm2=L.rmsnorm_init(b, f"{name}/norm2", cfg.d_model),
        mlp=L.mlp_init(b, f"{name}/mlp", cfg.d_model, cfg.d_ff))


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Tuple[Params, Dict]:
    """(params, logical axes): the parameter tree (`Params` nodes, the
    layers a `LayerStack`) drawn from ``generator`` on ``device``
    (the generator's device by default), and the same tree of logical
    axis names."""
    period_of(cfg)
    if device is None and generator is not None:
        device = generator.device
    b = ParamBuilder(generator, dtype=cfg.param_dtype, device=device)
    p: Dict[str, Any] = {"embed": L.embedding_init(b, cfg),
                         "final_norm": L.rmsnorm_init(b, "final_norm",
                                                      cfg.d_model)}
    p["blocks"] = LayerStack(
        (_block_init(b, f"blocks/{i}", cfg, i, cross=cfg.is_encdec)
         for i in range(cfg.num_layers)), period_of(cfg))
    if cfg.is_encdec:
        p["encoder"] = Params(
            blocks=LayerStack(
                _enc_block_init(b, f"encoder/blocks/{i}", cfg)
                for i in range(cfg.encoder_layers)),
            final_norm=L.rmsnorm_init(b, "encoder/final_norm", cfg.d_model))
    if cfg.frontend is not None:
        p["projector"] = Params(
            w=b.param("projector/w", (cfg.frontend.embed_dim, cfg.d_model),
                      ("frontend", "embed")),
            b=b.param("projector/b", (cfg.d_model,), (None,), init="zeros"))
    return Params(**p), unflatten_axes(b.axes)


# ---------------------------------------------------------------------------
# Block application — full-sequence (train / prefill)
# ---------------------------------------------------------------------------


def _self_attention(p, x, cfg: ModelConfig, layer: int, positions,
                    causal: bool, mesh, capture: bool = False):
    q, k, v = L.qkv_project(p, x, cfg, positions)
    q = constrain(q, mesh, "act_batch", None, "act_heads", None)
    window = cfg.sliding_window if cfg.layer_is_swa(layer) else 0
    c = attn_chunk(x.shape[1])
    o = _local_heads(functools.partial(
        L.chunked_attention, causal=causal, window=window, q_chunk=c,
        kv_chunk=c), q, k, v)
    o = L.out_project(p, o)
    return o, ((k, v) if capture else None)


def _uneven_spec(logical, shape, mesh, rules):
    """`resolve_spec`, and for a dim it leaves whole the first free
    candidate of its rule that is one mesh axis of more than one rank and
    leaves a rank less than the whole dim: that dim split unevenly,
    DTensor's chunks (the first ranks hold ⌈n / size⌉ entries, the last
    ones fewer or none) — XLA's partitioner pads such a dim to a multiple
    of the axis (ROADMAP §C W2). A single row stays whole (its rank would
    hold it all), as do splits over two axes (DTensor nests uneven
    chunks on neither torch). (spec, the dims split unevenly)."""
    spec = list(resolve_spec(logical, shape, mesh, rules))
    spec += [None] * (len(logical) - len(spec))
    sizes = mesh_shape(mesh)
    used = {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    table, uneven = dict(rules), []
    for d, name in enumerate(logical):
        if name is None or spec[d] is not None:
            continue
        for cand in table[name]:
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if (len(axes) == 1 and axes[0] in sizes
                    and axes[0] not in used and sizes[axes[0]] > 1
                    and -(-shape[d] // sizes[axes[0]]) < shape[d]):
                spec[d] = axes[0]
                used.add(axes[0])
                uneven.append(d)
                break
    return tuple(spec), uneven


def _local_heads(attn, q, k, v):
    """attn(q, k, v) on each rank's own rows and heads. Attention mixes
    no batch rows and no heads (a query head reads its group's key
    head), so over a mesh each rank runs it on its shard — the batch as
    act_batch splits it, the query heads as act_heads splits them — with
    no collective. Where the key heads do not divide the ranks that
    split the query heads (2 key heads over 16), the keys and values
    stay whole there and each rank takes the one key head its query
    heads read; their gradients come back as partial sums over those
    ranks. Where a group of query heads would straddle two ranks, every
    head runs whole on every rank. A batch or query heads that do not
    divide their ranks (4 rows over 16, 40 heads over 16) are split
    unevenly, as XLA pads them (§C W2): a rank takes the key heads its
    query heads read, one a query head, and a rank with no rows or no
    heads computes nothing. Plain tensors go straight through."""
    if not is_dtensor(q):
        return attn(q, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, rules = q.device_mesh, current_act_rules()

    spec, uneven = _uneven_spec(("act_batch", None, "act_heads", None),
                                q.shape, mesh, rules)
    want = placements(spec, mesh)
    rows = [p if p == Shard(0) else Replicate() for p in want]
    if 2 in uneven:
        # query heads split unevenly: keys and values whole on the head
        # dims, expanded locally to the key head of each query head
        kv_want, split = tuple(rows), []
    else:
        kv_want = placements(resolve_spec(
            ("act_batch", None, "act_kv_heads", None), k.shape, mesh,
            rules), mesh)
        kv_want = tuple(Shard(0) if r == Shard(0) else p
                        for r, p in zip(rows, kv_want))
        split = [d for d, (a, b) in enumerate(zip(want, kv_want)) if a != b]
    shard = 0
    for d in range(mesh.ndim):
        if want[d] == Shard(2):
            shard = shard * mesh.size(d) + mesh.get_coordinate()[d]
    hq = q.shape[2] // math.prod(mesh.size(d) for d in range(mesh.ndim)
                                 if want[d] == Shard(2))
    group = q.shape[2] // k.shape[2]
    if split and (Shard(2) in kv_want or group % hq
                  or any(want[d] != Shard(2) for d in split)):
        want = kv_want = tuple(rows)
        split = []
    q = q if tuple(q.placements) == want else q.redistribute(mesh, want)
    k, v = (t if tuple(t.placements) == kv_want
            else t.redistribute(mesh, kv_want) for t in (k, v))
    partial = [d for d in range(mesh.ndim)
               if d in split or (2 in uneven and want[d] == Shard(2))]
    grads = [Partial() if d in partial else p for d, p in enumerate(kv_want)]
    ql, kl, vl = (q.to_local(), k.to_local(grad_placements=grads),
                  v.to_local(grad_placements=grads))
    if split:
        head = shard * hq // group
        kl, vl = kl[:, :, head:head + 1], vl[:, :, head:head + 1]
    elif 2 in uneven:
        _, off = compute_local_shape_and_global_offset(q.shape, mesh, want)
        idx = (torch.arange(ql.shape[2], device=ql.device) + off[2]) // group
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    if ql.numel() == 0:
        # no rows or no heads here: an empty output that still takes
        # (zero) gradients, so every rank runs the same backward
        o = ql + 0.0 * (kl.sum() + vl.sum()).to(ql.dtype)
    else:
        o = attn(ql, kl, vl)
    return L.from_shard(o.contiguous(), mesh, want, q.shape)


def _cross_attention(p, h, ck, cv, cfg: ModelConfig):
    q = einsum32("bse,ehd->bshd", h, p["wq"]).to(h.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
    o = _local_heads(functools.partial(
        L.chunked_attention, causal=False, q_chunk=attn_chunk(h.shape[1]),
        kv_chunk=attn_chunk(ck.shape[1])), q, ck, cv)
    return L.out_project(p, o)


def cross_kv(p, memory: torch.Tensor, cfg: ModelConfig):
    """Project encoder memory to cross-attention K/V (no RoPE)."""
    dt = memory.dtype
    k = einsum32("bse,ehd->bshd", memory, p["wk"]).to(dt)
    v = einsum32("bse,ehd->bshd", memory, p["wv"]).to(dt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def _block_apply(p, x: torch.Tensor, cfg: ModelConfig, layer: int, *,
                 positions, causal: bool, mesh,
                 memory: Optional[torch.Tensor] = None,
                 capture: bool = False):
    """Full-seq block. Returns (x, aux, cache_entry|None)."""
    aux: Dict[str, torch.Tensor] = {}
    entry: Dict[str, Any] = {}
    h = L.rmsnorm(p["norm1"], x, cfg.rms_eps)
    if "attn" in p:
        h, kv = _self_attention(p["attn"], h, cfg, layer, positions, causal,
                                mesh, capture)
        if capture:
            entry["k"], entry["v"] = kv
    elif capture:
        h, st = M.mamba_apply_with_state(p["mamba"], h, cfg)
        entry.update(st)
    else:
        h = M.mamba_apply(p["mamba"], h, cfg)
    x = x + h
    if "cross" in p:
        h = L.rmsnorm(p["norm_x"], x, cfg.rms_eps)
        ck, cv = cross_kv(p["cross"], memory, cfg)
        if capture:
            entry["ck"], entry["cv"] = ck, cv
        x = x + _cross_attention(p["cross"], h, ck, cv, cfg)
    if "norm2" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.rms_eps)
        if "mlp" in p:
            h = L.mlp_apply(p["mlp"], h)
        else:
            h, aux = X.moe_apply(p["moe"], h, cfg, cfg.moe, mesh=mesh)
        x = x + h
    x = constrain(x, mesh, "act_batch", None, None)
    return x, aux, (entry if capture else None)


def _saveable(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep a product without batch
    dimensions (an mm, or einsum's bmm over a batch of 1), recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str, *args):
    """fn(*args) under the remat policy (plain when nothing is recorded)."""
    if remat not in ("block", "full") or not torch.is_grad_enabled():
        return fn(*args)
    ctx = {}
    if remat == "block":
        ctx["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _saveable)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **ctx)


def _run_blocks(blocks, x: torch.Tensor, cfg: ModelConfig, *, positions,
                causal: bool, mesh, remat: str = "none",
                memory: Optional[torch.Tensor] = None,
                capture: bool = False):
    """Every decoder layer in order → (x, summed aux, entries|None);
    under ``remat`` one checkpoint a repeat of the period."""
    aux: Dict[str, torch.Tensor] = {}
    if cfg.moe is not None:
        aux = {k: torch.zeros((), dtype=F32, device=x.device)
               for k in ("moe_load_balance", "moe_router_z",
                         "moe_drop_fraction")}
    entries: List[Dict[str, Any]] = []
    period = period_of(cfg)

    def repeat(r, h, mem):
        adds, ents = [], []
        for i in range(r * period, (r + 1) * period):
            h, a, entry = _block_apply(blocks[i], h, cfg, i,
                                       positions=positions, causal=causal,
                                       mesh=mesh, memory=mem,
                                       capture=capture)
            adds.append(a)
            ents.append(entry)
        return h, adds, ents

    for r in range(len(blocks) // period):
        x, adds, ents = _remat(functools.partial(repeat, r),
                               "none" if capture else remat, x, memory)
        for a in adds:
            for k, v in a.items():
                aux[k] = aux[k] + v
        entries.extend(ents)
    return x, aux, (entries if capture else None)


def _encode(params, memory_in: torch.Tensor, cfg: ModelConfig,
            mesh, remat: str = "none") -> torch.Tensor:
    enc = params["encoder"]
    positions = torch.arange(memory_in.shape[1],
                             device=memory_in.device)[None]

    def layer(p, h):
        hn = L.rmsnorm(p["norm1"], h, cfg.rms_eps)
        hn, _ = _self_attention(p["attn"], hn, cfg, 0, positions, False,
                                mesh)
        h = h + hn
        hn = L.rmsnorm(p["norm2"], h, cfg.rms_eps)
        return h + L.mlp_apply(p["mlp"], hn)

    h = memory_in
    plain = "full" if remat in ("block", "full") else "none"
    for p in enc["blocks"]:
        h = _remat(functools.partial(layer, p), plain, h)
    return L.rmsnorm(enc["final_norm"], h, cfg.rms_eps)


def _project_frontend(params, embeds: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    proj = einsum32("bpe,ed->bpd", embeds.to(dtype),
                    params["projector"]["w"].to(dtype)).to(dtype)
    return proj + params["projector"]["b"].to(dtype)


def _embed_inputs(params, batch: Dict, cfg: ModelConfig,
                  mesh) -> torch.Tensor:
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if (cfg.frontend is not None and cfg.frontend.kind == "vision"
            and "patches" in batch):
        # the projected patches overwrite the first positions
        proj = _project_frontend(params, batch["patches"], x.dtype)
        npatch = min(proj.shape[1], x.shape[1])
        x = torch.cat([proj[:, :npatch], x[:, npatch:]], dim=1)
    return constrain(x, mesh, "act_batch", None, None)


def _maybe_memory(params, batch, cfg: ModelConfig, mesh, dtype,
                  remat: str = "none"):
    """The encoder's output over the projected audio frames (enc-dec)."""
    if not cfg.is_encdec:
        return None
    mem_in = _project_frontend(params, batch["frames"], dtype)
    return _encode(params, mem_in, cfg, mesh, remat)


# ---------------------------------------------------------------------------
# Entry point 1: training forward
# ---------------------------------------------------------------------------


def forward(params, batch: Dict, cfg: ModelConfig, mesh=None,
            remat: str = "block") -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward → (logits (B,S,V) fp32, aux)."""
    x = _embed_inputs(params, batch, cfg, mesh)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    memory = _maybe_memory(params, batch, cfg, mesh, x.dtype, remat)
    x, aux, _ = _run_blocks(params["blocks"], x, cfg, positions=positions,
                            causal=True, mesh=mesh, remat=remat,
                            memory=memory)
    x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = L.lm_logits(params["embed"], x, cfg)
    logits = constrain(logits, mesh, "act_batch", None, "act_vocab")
    return logits, aux


def loss_fn(params, batch: Dict, cfg: ModelConfig, mesh=None,
            remat: str = "block", label_smoothing: float = 0.0
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(params, batch, cfg, mesh, remat)
    mask = (batch["labels"] >= 0).to(F32)
    labels = torch.clamp(batch["labels"], min=0)
    ce = L.cross_entropy(logits, labels, mask, label_smoothing)
    loss = ce
    if cfg.moe is not None:
        loss = (loss
                + cfg.moe.router_aux_weight * aux["moe_load_balance"]
                + cfg.moe.router_z_weight * aux["moe_router_z"])
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Entry point 2: prefill (forward + cache capture)
# ---------------------------------------------------------------------------


def prefill(params, batch: Dict, cfg: ModelConfig, mesh=None,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Returns (last-token logits (B,V) fp32, cache).

    ``max_len`` sizes full-attention cache buffers (≥ seq + tokens you plan
    to decode); SWA layers use ring buffers of the window size.
    """
    x = _embed_inputs(params, batch, cfg, mesh)
    seq = x.shape[1]
    max_len = max_len or seq
    positions = torch.arange(seq, device=x.device)[None]
    memory = _maybe_memory(params, batch, cfg, mesh, x.dtype)
    x, _, entries = _run_blocks(params["blocks"], x, cfg,
                                positions=positions, causal=True, mesh=mesh,
                                memory=memory, capture=True)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.rms_eps)
    logits = L.lm_logits(params["embed"], x, cfg)[:, 0]

    # post-process captured entries into the decode-cache layout
    cache_layers = []
    for i, e in enumerate(entries):
        out: Dict[str, Any] = {}
        if "k" in e:
            buf = _cache_len(cfg, i, max_len)
            k, v = e["k"], e["v"]
            if cfg.layer_is_swa(i) and buf < seq:
                # SWA ring: token p → slot p % W, i.e. the last W tokens
                # rotated by (seq − W) % W (slices and a concatenation:
                # DTensor has rules for them, not for index_copy)
                out["k"], out["v"] = (_ring(t[:, -buf:], (seq - buf) % buf)
                                      for t in (k, v))
            elif buf > seq:                    # headroom for decode steps
                out["k"], out["v"] = (_pad_positions(t, buf - seq)
                                      for t in (k, v))
            else:
                out["k"], out["v"] = k, v
            out["k"] = constrain(out["k"], mesh, "act_batch", "act_kv_seq",
                                 "act_kv_heads", None)
            out["v"] = constrain(out["v"], mesh, "act_batch", "act_kv_seq",
                                 "act_kv_heads", None)
        for key in ("conv_x", "conv_B", "conv_C", "state", "ck", "cv"):
            if key in e:
                out[key] = e[key]
        cache_layers.append(out)
    return logits, {"layers": cache_layers, "index": seq}


def _pad_positions(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, …) `t` with n zero positions after its last. Over a mesh the
    pad runs on each rank's shard (no mesh dim splits the positions here):
    torch 2.11's DTensor cannot plan ``F.pad``'s redistribution."""
    pad = (0, 0) * (t.dim() - 2) + (0, n)
    if not is_dtensor(t) or any(p.is_shard(1) for p in t.placements):
        return F.pad(t, pad)
    shape = (t.shape[0], t.shape[1] + n) + tuple(t.shape[2:])
    return L.from_shard(F.pad(t.to_local(), pad), t.device_mesh,
                        t.placements, shape)


def _ring(last: torch.Tensor, shift: int) -> torch.Tensor:
    """The ring buffer holding `last` (B, W, …), token j at slot
    (shift + j) % W."""
    if shift == 0:
        return last
    w = last.shape[1]
    return torch.cat([last[:, w - shift:], last[:, :w - shift]], dim=1)


# ---------------------------------------------------------------------------
# Entry point 3: single-token decode
# ---------------------------------------------------------------------------


def _attn_decode(p, h, cfg: ModelConfig, layer: int, entry: Dict,
                 index: int, mesh):
    """h: (B,1,E); entry holds k/v buffers (B,T,Kv,D)."""
    bsz = h.shape[0]
    buf = entry["k"].shape[1]
    pos = torch.full((bsz, 1), index, dtype=torch.int64, device=h.device)
    q, k, v = L.qkv_project(p, h, cfg, pos)
    # SWA layers use a ring buffer (token p → slot p % W); full-attention
    # layers write at the absolute index (the buffer is sized for it)
    slot = index % buf if cfg.layer_is_swa(layer) else index
    if slot >= buf:
        raise ValueError(f"layer {layer}: position {index} is past the "
                         f"cache's {buf} slots (prefill's max_len)")
    kc = entry["k"].slice_scatter(k.to(entry["k"].dtype), 1, slot, slot + 1)
    vc = entry["v"].slice_scatter(v.to(entry["v"].dtype), 1, slot, slot + 1)
    kc = constrain(kc, mesh, "act_batch", "act_kv_seq", "act_kv_heads", None)
    vc = constrain(vc, mesh, "act_batch", "act_kv_seq", "act_kv_heads", None)
    count = min(index + 1, buf)
    valid = (torch.arange(buf, device=h.device) < count)[None]
    o = _local_heads(lambda q_, k_, v_: L.decode_attention(
        q_, k_, v_, valid.expand(q_.shape[0], buf)), q, kc, vc)
    return L.out_project(p, o), {"k": kc, "v": vc}


def decode_step(params, cache: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B,1) → (logits (B,V) fp32, new cache).
    The cache handed in is left as it was."""
    index = int(cache["index"])
    h = L.embed_tokens(params["embed"], tokens, cfg)
    h = constrain(h, mesh, "act_batch", None, None)
    new_layers = []
    for i, (p, e) in enumerate(zip(params["blocks"], cache["layers"])):
        hn = L.rmsnorm(p["norm1"], h, cfg.rms_eps)
        if "attn" in p:
            hn, ne = _attn_decode(p["attn"], hn, cfg, i, e, index, mesh)
        else:
            hn, ne = M.mamba_decode_step(p["mamba"], e, hn, cfg)
        h = h + hn
        if "cross" in p:
            hc = L.rmsnorm(p["norm_x"], h, cfg.rms_eps)
            h = h + _cross_attention(p["cross"], hc, e["ck"], e["cv"], cfg)
            ne["ck"], ne["cv"] = e["ck"], e["cv"]
        if "norm2" in p:
            hn = L.rmsnorm(p["norm2"], h, cfg.rms_eps)
            if "mlp" in p:
                h = h + L.mlp_apply(p["mlp"], hn)
            else:
                out, _ = X.moe_apply(p["moe"], hn, cfg, cfg.moe, mesh=mesh)
                h = h + out
        new_layers.append(ne)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    logits = L.lm_logits(params["embed"], h, cfg)[:, 0]
    return logits, {"layers": new_layers, "index": index + 1}


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0) -> Tuple[Dict, Dict]:
    """The decode cache's (shape, dtype) of every buffer, per layer, and
    the same tree of logical axes."""
    dt = L.dtype_of(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv_axes = ("act_batch", "act_kv_seq", "act_kv_heads", None)
    layers, axes = [], []
    for i in range(cfg.num_layers):
        if cfg.mixer_kind(i) == "attn":
            buf = _cache_len(cfg, i, max_len)
            e = {"k": ((batch, buf, kv, hd), dt),
                 "v": ((batch, buf, kv, hd), dt)}
            a = {"k": kv_axes, "v": kv_axes}
        else:
            e = M.mamba_cache_spec(cfg, batch, dt)
            a = M.mamba_cache_axes(cfg)
        if cfg.is_encdec:
            e["ck"] = e["cv"] = ((batch, enc_len, kv, hd), dt)
            a["ck"] = a["cv"] = kv_axes
        layers.append(e)
        axes.append(a)
    return ({"layers": layers, "index": ((), torch.int64)},
            {"layers": axes, "index": ()})


def cache_init(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None) -> Dict:
    """Zero-filled concrete cache (serving from scratch)."""
    spec, _ = cache_spec(cfg, batch, max_len, enc_len)
    return {"layers": [{k: torch.zeros(shape, dtype=dt, device=device)
                        for k, (shape, dt) in e.items()}
                       for e in spec["layers"]],
            "index": 0}
