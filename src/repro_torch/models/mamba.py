"""Mamba-2 SSD (state-space duality) mixer — chunked matmul formulation
(answers `src/repro/models/mamba.py`, whole).

The SSD scan is computed per chunk of length Q: intra-chunk terms are
dense (Q×Q) products, inter-chunk terms flow through a sequential loop
over the chunks carrying the (B, H, N, P) f32 state. Decode is the exact
one-step recurrence with a conv window and SSM state cache. The causal
conv is the reference's W shifted multiply-adds in f32 (no cuDNN
convolution, which may take TF32).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, einsum32, from_shard, rmsnorm
from repro_torch.sharding.axes import ParamBuilder, is_dtensor

F32 = torch.float32


def _inv_softplus(x: np.ndarray) -> np.ndarray:
    return x + np.log(-np.expm1(-x))


def mamba_init(b: ParamBuilder, name: str, cfg: ModelConfig) -> Params:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner(cfg.d_model)
    h, g, n, w = s.n_heads(cfg.d_model), s.n_groups, s.d_state, s.conv_width
    gn = g * n
    # deterministic SSD inits (A ∈ [1,16], dt log-uniform in [dt_min, dt_max])
    a_init = np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))
    dt_init = _inv_softplus(np.exp(np.linspace(
        math.log(s.dt_min), math.log(s.dt_max), h)).astype(np.float32))
    return Params(
        w_z=b.param(f"{name}/w_z", (d, di), ("embed", "dinner")),
        w_x=b.param(f"{name}/w_x", (d, di), ("embed", "dinner")),
        w_B=b.param(f"{name}/w_B", (d, gn), ("embed", None)),
        w_C=b.param(f"{name}/w_C", (d, gn), ("embed", None)),
        w_dt=b.param(f"{name}/w_dt", (d, h), ("embed", "ssm_heads")),
        conv_x=b.param(f"{name}/conv_x", (w, di), ("conv", "dinner"),
                       scale=1.0 / math.sqrt(w)),
        conv_B=b.param(f"{name}/conv_B", (w, gn), ("conv", None),
                       scale=1.0 / math.sqrt(w)),
        conv_C=b.param(f"{name}/conv_C", (w, gn), ("conv", None),
                       scale=1.0 / math.sqrt(w)),
        A_log=b.custom(f"{name}/A_log", torch.from_numpy(a_init),
                       ("ssm_heads",)),
        dt_bias=b.custom(f"{name}/dt_bias", torch.from_numpy(dt_init),
                         ("ssm_heads",)),
        D=b.param(f"{name}/D", (h,), ("ssm_heads",), init="ones"),
        norm_scale=b.param(f"{name}/norm_scale", (di,), ("dinner",),
                           init="ones"),
        out_proj=b.param(f"{name}/out_proj", (di, d), ("dinner", "embed"),
                         scale=1.0 / math.sqrt(di)))


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), kernel: (W,C) → (B,S,C)."""
    w = kernel.shape[0]
    xp = F.pad(x, (0, 0, w - 1, 0))
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(w):
        out = out + xp[:, i:i + s].to(F32) * kernel[i].to(F32)
    return out.to(x.dtype)


def _conv_step(state: torch.Tensor, xt: torch.Tensor, kernel: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """state: (B,W-1,C), xt: (B,C) → (new_state, yt)."""
    window = torch.cat([state, xt[:, None]], dim=1)           # (B,W,C)
    yt = einsum32("bwc,wc->bc", window, kernel).to(xt.dtype)
    return window[:, 1:], yt


def _project(params, u: torch.Tensor, cfg: ModelConfig):
    """u: (B,S,E) → z,x,(B),(C),dt before conv/activation."""
    dt_ = u.dtype
    z = einsum32("bse,ei->bsi", u, params["w_z"]).to(dt_)
    x = einsum32("bse,ei->bsi", u, params["w_x"]).to(dt_)
    bb = einsum32("bse,ei->bsi", u, params["w_B"]).to(dt_)
    cc = einsum32("bse,ei->bsi", u, params["w_C"]).to(dt_)
    dt_raw = einsum32("bse,eh->bsh", u, params["w_dt"])
    return z, x, bb, cc, dt_raw


# ---------------------------------------------------------------------------
# Over a mesh: the scan on each rank's own rows and heads
# ---------------------------------------------------------------------------
#
# The SSD scan and its decode step mix no batch rows and no heads (the B/C
# projections are shared by every head), so over a mesh each rank runs them
# on its local tensors — the rows as act_batch splits them, d_inner and the
# heads as act_mlp / act_heads split them — as `transformer._local_heads`
# does for attention: no collective inside the scan, and no DTensor rule
# for its pads, views and loops. The gated RMSNorm runs there too, its sum
# of squares summed over the head ranks; the out-projection runs on
# DTensors again (a partial sum over the head ranks).

_VEC = ("dt_bias", "A_log", "D")


class _Local:
    """The layout of one mixer call over `u`'s mesh: ``bdims`` (the mesh
    dims that split the rows evenly), ``hdims`` (those that split
    d_inner and the SSM heads alike)."""

    def __init__(self, u, z, dt_raw):
        from repro_torch.sharding.axes import (current_act_rules,
                                               resolve_spec)
        from torch.distributed.tensor import Shard
        self.mesh = mesh = u.device_mesh
        rules = current_act_rules()
        bdims = [d for d, p in enumerate(u.placements)
                 if type(p) is Shard and p.dim == 0]
        if u.shape[0] % math.prod(mesh.size(d) for d in bdims):
            bdims = []
        self.bdims = bdims

        def split(t, name):
            spec = resolve_spec(("act_batch", None, name), t.shape, mesh,
                                rules)
            entry = spec[2] if len(spec) > 2 else None
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            return [d for d, n in enumerate(mesh.mesh_dim_names)
                    if n in names and d not in bdims]
        hd = split(dt_raw, "act_heads")
        self.hdims = hd if hd == split(z, "act_mlp") else []

    def placements(self, dim):
        """Rows on the batch dims, tensor dim `dim` (None: none) on the
        head dims."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(0) if d in self.bdims else
                (Shard(dim) if dim is not None and d in self.hdims
                 else Replicate()) for d in range(self.mesh.ndim)]

    def local(self, t, dim, rows: bool = True):
        """DTensor `t` laid out by `placements` (its rows on the batch
        dims where ``rows``), as this rank's tensor. Its gradient is a
        partial sum on a batch dim where it has no rows and on a head dim
        where it has no head dim (every head reads it)."""
        from torch.distributed.tensor import Partial, Replicate
        want = self.placements(dim)
        if not rows:
            want = [Replicate() if d in self.bdims else p
                    for d, p in enumerate(want)]
        if list(t.placements) != want:
            t = t.redistribute(self.mesh, want)
        grads = [Partial() if (d in self.bdims and not rows)
                 or (d in self.hdims and dim is None) else p
                 for d, p in enumerate(want)]
        return t.to_local(grad_placements=grads)

    def wrap(self, t, dim, shape):
        """This rank's `t` as the DTensor of global ``shape``."""
        return from_shard(t.contiguous(), self.mesh, self.placements(dim),
                          shape)

    def norm(self, y, scale, eps: float, rows_seq):
        """The gated output's RMSNorm over d_inner on this rank's
        channels, its sum of squares summed over the head ranks: the
        normed (B, S, d_inner) DTensor."""
        from torch.distributed.tensor import Partial
        dt_ = y.dtype
        yf = y.to(F32)
        ss = yf.square().sum(-1, keepdim=True)
        if self.hdims:
            ss = from_shard(ss, self.mesh, [
                Partial() if d in self.hdims else p
                for d, p in enumerate(self.placements(None))],
                tuple(rows_seq) + (1,))
            # each rank's channels read the sum: its gradient is a
            # partial sum over the head ranks
            ss = ss.redistribute(self.mesh, self.placements(None)).to_local(
                grad_placements=[Partial() if d in self.hdims else p
                                 for d, p in enumerate(
                                     self.placements(None))])
        di = yf.shape[-1] * math.prod(self.mesh.size(d) for d in self.hdims)
        out = yf * torch.rsqrt(ss / di + eps)
        out = (out * self.local(scale, 0, rows=False).to(F32)).to(dt_)
        return self.wrap(out, 2, tuple(rows_seq) + (di,))

    def head0(self, t) -> int:
        """The first SSM head of this rank's local (…, H) tensor `t`."""
        k = 0
        for d in self.hdims:
            k = k * self.mesh.size(d) + self.mesh.get_coordinate()[d]
        return k * t.shape[-1]

    def inputs(self, z, x, bb, cc, dt_raw):
        """The projections on this rank: z, x and dt on its rows and
        heads, B and C on its rows."""
        return (*(self.local(t, 2) for t in (z, x)),
                *(self.local(t, None) for t in (bb, cc)),
                self.local(dt_raw, 2))

    def params(self, params):
        """The scan's parameters on this rank (conv_x's channels and the
        per-head vectors of its heads)."""
        out = {"conv_x": self.local(params["conv_x"], 1, rows=False),
               "conv_B": self.local(params["conv_B"], None, rows=False),
               "conv_C": self.local(params["conv_C"], None, rows=False)}
        out.update({k: self.local(params[k], 0, rows=False) for k in _VEC})
        return out


def mamba_apply(params, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training forward. u: (B,S,E) → (B,S,E)."""
    y, _ = _mamba_forward(params, u, cfg, return_state=False)
    return y


def mamba_apply_with_state(params, u: torch.Tensor, cfg: ModelConfig):
    """Prefill forward: returns (y, decode-cache entry)."""
    return _mamba_forward(params, u, cfg, return_state=True)


def _tail_window(x: torch.Tensor, w: int) -> torch.Tensor:
    """Last w timesteps of (B,S,C), left-padded with zeros if S < w."""
    s = x.shape[1]
    if s >= w:
        return x[:, s - w:]
    return F.pad(x, (0, 0, w - s, 0))


def _mamba_forward(params, u: torch.Tensor, cfg: ModelConfig,
                   return_state: bool):
    s_cfg = cfg.ssm
    bsz, seq0, _ = u.shape
    q = min(s_cfg.chunk_size, seq0)
    # left-pad to a chunk multiple: zero inputs contribute nothing to the
    # state (dt·x·B = 0) and the initial state is zero, so outputs for the
    # real positions are exact. (Over a mesh the projections of the zero
    # rows, zeros, are padded on each rank.)
    pad = (-seq0) % q
    if pad and not is_dtensor(u):
        u = F.pad(u, (0, 0, pad, 0))
    dt_ = u.dtype

    z, x, bb, cc, dt_raw = _project(params, u, cfg)
    lay, p = None, params
    if is_dtensor(u):
        lay = _Local(u, z, dt_raw)
        p = lay.params(params)
        z, x, bb, cc, dt_raw = lay.inputs(z, x, bb, cc, dt_raw)
        if pad:
            z, x, bb, cc, dt_raw = (F.pad(t, (0, 0, pad, 0))
                                    for t in (z, x, bb, cc, dt_raw))
    y, state_entry = _scan(p, z, x, bb, cc, dt_raw, cfg, q, return_state,
                           lay.head0(dt_raw) if lay else 0)
    if lay is not None:
        y = lay.norm(y, params["norm_scale"], cfg.rms_eps,
                     (bsz, seq0 + pad))
        if return_state:
            state_entry = _wrap_cache(lay, state_entry, bsz, cfg)
    else:
        y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.rms_eps)
    # out-projection (over a mesh a partial sum over the head ranks)
    out = einsum32("bsi,ie->bse", y, params["out_proj"]).to(dt_)
    if pad:
        out = out[:, pad:]
    if return_state:
        return out, state_entry
    return out, None


def _scan(params, z, x, bb, cc, dt_raw, cfg: ModelConfig, q: int,
          return_state: bool, h0: int = 0):
    """The SSD scan of (B,S,·) projections (S a multiple of the chunk
    `q`), gated by silu(z): (y (B,S,H·P), the decode-cache entry or
    None). H is the heads `x` holds, from head `h0` (a rank's own over a
    mesh)."""
    s_cfg = cfg.ssm
    bsz, seq, _ = x.shape
    g, n, p = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    h = dt_raw.shape[-1]
    nc = seq // q
    dt_ = x.dtype
    state_entry = None
    if return_state:
        w = s_cfg.conv_width
        state_entry = {"conv_x": _tail_window(x, w - 1),
                       "conv_B": _tail_window(bb, w - 1),
                       "conv_C": _tail_window(cc, w - 1)}
    x = F.silu(_causal_conv(x, params["conv_x"]).to(F32)).to(dt_)
    bb = F.silu(_causal_conv(bb, params["conv_B"]).to(F32)).to(dt_)
    cc = F.silu(_causal_conv(cc, params["conv_C"]).to(F32)).to(dt_)

    dt = F.softplus(dt_raw + params["dt_bias"].to(F32))            # (B,S,H)
    a = -torch.exp(params["A_log"].to(F32))                        # (H,)
    alpha = dt * a                                                 # ≤ 0

    xr = x.reshape(bsz, nc, q, h, p)
    br = bb.reshape(bsz, nc, q, g, n)
    cr = cc.reshape(bsz, nc, q, g, n)
    dtr = dt.reshape(bsz, nc, q, h)
    ar = alpha.reshape(bsz, nc, q, h)
    cum = torch.cumsum(ar, dim=2)                                  # inclusive

    # ---- intra-chunk (dense, masked) --------------------------------------
    # scores[l,s] = C_l · B_s per group, broadcast to that group's heads
    heads_per_g = s_cfg.n_heads(cfg.d_model) // g
    scores = einsum32("bclgn,bcsgn->bcgls", cr, br)
    scores = _group_heads(scores, heads_per_g, h0, h, 2)  # b,c,h,l,s
    # decay[l,s] = exp(cum[l] - cum[s]) for l ≥ s, the exponent masked
    # BEFORE exp (for l < s it is positive and exp would overflow)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # b,c,l,s,h
    diff = torch.where(mask[None, None, :, :, None], diff, -1e30)
    decay = torch.exp(diff).movedim(-1, 2)                        # b,c,h,l,s
    m = torch.where(mask[None, None, None], scores * decay, 0.0)
    m = m * dtr.movedim(-1, 2)[:, :, :, None, :]                   # × dt_s
    y_intra = einsum32("bchls,bcshp->bclhp", m.to(dt_), xr)

    # ---- chunk states ------------------------------------------------------
    last = cum[:, :, -1:, :]                                       # (b,c,1,h)
    w_s = torch.exp(last - cum) * dtr                              # (b,c,q,h)
    br_h = _group_heads(br, heads_per_g, h0, h, 3)        # b,c,q,h,n
    chunk_state = einsum32("bcshn,bcsh,bcshp->bchnp", br_h, w_s, xr)

    # ---- inter-chunk sequential scan --------------------------------------
    cr_h = _group_heads(cr, heads_per_g, h0, h, 3).to(F32)
    st = torch.zeros((bsz, h, n, p), dtype=F32, device=x.device)
    ys = []
    for c in range(nc):
        ys.append(einsum32("bshn,bsh,bhnp->bshp", cr_h[:, c],
                           torch.exp(cum[:, c]), st))
        st = (torch.exp(last[:, c, 0])[:, :, None, None] * st
              + chunk_state[:, c])
    y_inter = torch.stack(ys, dim=1)                              # b,c,q,h,p

    y = (y_intra + y_inter).reshape(bsz, seq, h, p)
    y = y + params["D"].to(F32)[None, None, :, None] * x.reshape(
        bsz, seq, h, p).to(F32)
    y = y.reshape(bsz, seq, h * p).to(dt_)
    y = y * F.silu(z.to(F32)).to(dt_)
    if return_state:
        state_entry["state"] = st
    return y, state_entry


def _group_heads(t, heads_per_g: int, h0: int, h: int, dim: int):
    """(…, G, …) per-group values repeated for each group's heads along
    `dim`: heads h0 … h0 + h − 1 (a rank's own over a mesh)."""
    if h0 == 0 and t.shape[dim] * heads_per_g == h:
        return torch.repeat_interleave(t, heads_per_g, dim=dim)
    idx = (torch.arange(h, device=t.device) + h0) // heads_per_g
    return t.index_select(dim, idx)


# ---------------------------------------------------------------------------
# Decode (exact one-step recurrence)
# ---------------------------------------------------------------------------


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each decode-cache buffer of one Mamba layer."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    h, g, n, p, w = (s.n_heads(cfg.d_model), s.n_groups, s.d_state,
                     s.head_dim, s.conv_width)
    return {
        "conv_x": ((batch, w - 1, di), dtype),
        "conv_B": ((batch, w - 1, g * n), dtype),
        "conv_C": ((batch, w - 1, g * n), dtype),
        "state": ((batch, h, n, p), F32),
    }


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba_cache_spec(cfg, batch, dtype).items()}


def mamba_cache_axes(cfg: ModelConfig) -> Dict:
    return {
        "conv_x": ("act_batch", None, "act_mlp"),
        "conv_B": ("act_batch", None, None),
        "conv_C": ("act_batch", None, None),
        "state": ("act_batch", "act_heads", None, None),
    }


def _wrap_cache(lay: _Local, e: Dict, bsz: int, cfg: ModelConfig) -> Dict:
    """A rank's cache entry as DTensors laid out by `mamba_cache_axes`:
    rows on the batch dims, conv_x's channels and the state's heads on
    the head dims."""
    spec = mamba_cache_spec(cfg, bsz, e["conv_x"].dtype)
    dims = {"conv_x": 2, "conv_B": None, "conv_C": None, "state": 1}
    return {k: lay.wrap(v, dims[k], spec[k][0]) for k, v in e.items()}


def mamba_decode_step(params, cache: Dict, ut: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """ut: (B,1,E) one token → (yt (B,1,E), new cache). Over a mesh the
    step runs on each rank's rows and heads of the cache."""
    dt_ = ut.dtype
    z, x, bb, cc, dt_raw = _project(params, ut, cfg)
    lay, p = None, params
    if is_dtensor(ut):
        lay = _Local(ut, z, dt_raw)
        p = lay.params(params)
        z, x, bb, cc, dt_raw = lay.inputs(z, x, bb, cc, dt_raw)
        cache = {"conv_x": lay.local(cache["conv_x"], 2),
                 "conv_B": lay.local(cache["conv_B"], None),
                 "conv_C": lay.local(cache["conv_C"], None),
                 "state": lay.local(cache["state"], 1)}
    y, new_cache = _decode_core(p, cache, z, x, bb, cc, dt_raw, cfg,
                                lay.head0(dt_raw) if lay else 0)
    if lay is not None:
        bsz = ut.shape[0]
        y = lay.norm(y, params["norm_scale"], cfg.rms_eps, (bsz, 1))
        new_cache = _wrap_cache(lay, new_cache, bsz, cfg)
    else:
        y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.rms_eps)
    yt = einsum32("bsi,ie->bse", y, params["out_proj"]).to(dt_)
    return yt, new_cache


def _decode_core(params, cache: Dict, z, x, bb, cc, dt_raw,
                 cfg: ModelConfig, h0: int = 0):
    """The one-step recurrence on (B,1,·) projections and the cache of
    the heads `x` holds (from head `h0`), gated by silu(z): (y (B,1,H·P),
    the new cache)."""
    s_cfg = cfg.ssm
    g, n, p = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    h = dt_raw.shape[-1]
    dt_ = x.dtype
    bsz = x.shape[0]
    heads_per_g = s_cfg.n_heads(cfg.d_model) // g

    conv_x, xt = _conv_step(cache["conv_x"], x[:, 0], params["conv_x"])
    conv_B, bt = _conv_step(cache["conv_B"], bb[:, 0], params["conv_B"])
    conv_C, ct = _conv_step(cache["conv_C"], cc[:, 0], params["conv_C"])
    xt = F.silu(xt.to(F32))                                        # (B,di)
    bt = F.silu(bt.to(F32)).reshape(bsz, g, n)
    ct = F.silu(ct.to(F32)).reshape(bsz, g, n)

    dt = F.softplus(dt_raw[:, 0] + params["dt_bias"].to(F32))      # (B,H)
    a = -torch.exp(params["A_log"].to(F32))
    decay = torch.exp(dt * a)                                      # (B,H)

    xh = xt.reshape(bsz, h, p)
    bh = _group_heads(bt, heads_per_g, h0, h, 1)                   # (B,H,N)
    ch = _group_heads(ct, heads_per_g, h0, h, 1)
    st = cache["state"]                                            # (B,H,N,P)
    st = decay[:, :, None, None] * st + torch.einsum(
        "bhn,bh,bhp->bhnp", bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", ch, st)                      # (B,H,P)
    y = y + params["D"].to(F32)[None, :, None] * xh
    y = y.reshape(bsz, 1, h * p).to(dt_)
    y = y * F.silu(z.to(F32)).to(dt_)
    new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "state": st}
    return y, new_cache
