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
from repro_torch.models.layers import Params, einsum32, rmsnorm
from repro_torch.sharding.axes import ParamBuilder

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
    h, g, n, p = (s_cfg.n_heads(cfg.d_model), s_cfg.n_groups, s_cfg.d_state,
                  s_cfg.head_dim)
    q = min(s_cfg.chunk_size, seq0)
    # left-pad to a chunk multiple: zero inputs contribute nothing to the
    # state (dt·x·B = 0) and the initial state is zero, so outputs for the
    # real positions are exact.
    pad = (-seq0) % q
    if pad:
        u = F.pad(u, (0, 0, pad, 0))
    seq = seq0 + pad
    nc = seq // q
    dt_ = u.dtype

    z, x, bb, cc, dt_raw = _project(params, u, cfg)
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
    heads_per_g = h // g
    scores = einsum32("bclgn,bcsgn->bcgls", cr, br)
    scores = torch.repeat_interleave(scores, heads_per_g, dim=2)  # b,c,h,l,s
    # decay[l,s] = exp(cum[l] - cum[s]) for l ≥ s, the exponent masked
    # BEFORE exp (for l < s it is positive and exp would overflow)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # b,c,l,s,h
    diff = torch.where(mask[None, None, :, :, None], diff, -1e30)
    decay = torch.exp(diff).movedim(-1, 2)                        # b,c,h,l,s
    m = torch.where(mask[None, None, None], scores * decay, 0.0)
    m = m * dtr.movedim(-1, 2)[:, :, :, None, :]                   # × dt_s
    y_intra = einsum32("bchls,bcshp->bclhp", m.to(dt_), xr)

    # ---- chunk states ------------------------------------------------------
    last = cum[:, :, -1:, :]                                       # (b,c,1,h)
    w_s = torch.exp(last - cum) * dtr                              # (b,c,q,h)
    br_h = torch.repeat_interleave(br, heads_per_g, dim=3)        # b,c,q,h,n
    chunk_state = einsum32("bcshn,bcsh,bcshp->bchnp", br_h, w_s, xr)

    # ---- inter-chunk sequential scan --------------------------------------
    cr_h = torch.repeat_interleave(cr, heads_per_g, dim=3).to(F32)
    st = torch.zeros((bsz, h, n, p), dtype=F32, device=u.device)
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

    # gated RMSNorm + out-projection
    y = y * F.silu(z.to(F32)).to(dt_)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.rms_eps)
    out = einsum32("bsi,ie->bse", y, params["out_proj"]).to(dt_)
    if pad:
        out = out[:, pad:]
    if return_state:
        state_entry["state"] = st
        return out, state_entry
    return out, None


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


def mamba_decode_step(params, cache: Dict, ut: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """ut: (B,1,E) one token → (yt (B,1,E), new cache)."""
    s_cfg = cfg.ssm
    h, g, n, p = (s_cfg.n_heads(cfg.d_model), s_cfg.n_groups, s_cfg.d_state,
                  s_cfg.head_dim)
    dt_ = ut.dtype
    bsz = ut.shape[0]
    heads_per_g = h // g

    z, x, bb, cc, dt_raw = _project(params, ut, cfg)
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
    bh = torch.repeat_interleave(bt, heads_per_g, dim=1)           # (B,H,N)
    ch = torch.repeat_interleave(ct, heads_per_g, dim=1)
    st = cache["state"]                                            # (B,H,N,P)
    st = decay[:, :, None, None] * st + torch.einsum(
        "bhn,bh,bhp->bhnp", bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", ch, st)                      # (B,H,P)
    y = y + params["D"].to(F32)[None, :, None] * xh
    y = y.reshape(bsz, 1, h * p).to(dt_)

    y = y * F.silu(z.to(F32)).to(dt_)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.rms_eps)
    yt = einsum32("bsi,ie->bse", y, params["out_proj"]).to(dt_)
    new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "state": st}
    return yt, new_cache
