"""Adafactor (Shazeer & Stern 2018), factored second moment, no momentum
(answers `src/repro/optim/adafactor.py`).

The reference's optimizer sees each block parameter STACKED over the
repeats of the layer period (`blocks/pos{i}/…` of shape (R, …)), and two
of its behaviours depend on it:

  * a leaf is factored when its stacked rank is ≥ 2, so a per-layer
    (d,) norm scale or bias, stacked (R, d), is factored: ``vr`` (R,),
    ``vc`` (d,) shared across the layers, one ``mean(vr)`` over them;
  * the update clip ``u / max(1, rms(u))`` takes one RMS over the whole
    stack.

So the state stays in the reference's stacked shapes, keyed by its leaf
paths (``{"step", "fac": {"blocks": {"pos0": {"attn": {"wq": {"vr",
"vc"}}}}}}``), and the update walks `tree.stacked_leaves`: a stacked
leaf of per-layer rank ≥ 2 runs layer by layer on its slices of ``vr``
and ``vc`` (the reference's means are per layer there), a stacked
rank-0/1 leaf on its (small) stack, and ``u`` is scaled by the RMS of
all its layers. Top-level leaves (``final_norm``, ``projector/b``, the
encoder's ``final_norm``: rank 1) stay unfactored, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import OptimConfig
from repro_torch.optim.tree import get_path, leaves, set_path, stacked_leaves
from repro_torch.sharding.axes import select0

F32 = torch.float32
_EPS1 = 1e-30
_CLIP = 1.0


def _factored(shape) -> bool:
    # rank-only, as the reference's (the state and axes trees agree)
    return len(shape) >= 2


def _full_shape(leaf, ps) -> Tuple[int, ...]:
    shape = tuple(ps[leaf.index[0]].shape)
    return ((len(leaf.index),) + shape) if leaf.stacked else shape


def init_opt_state(params, ocfg: OptimConfig) -> Dict[str, Any]:
    ps = leaves(params)
    dev = ps[0].device
    fac: Dict[str, Any] = {}
    for leaf in stacked_leaves(params):
        shape = _full_shape(leaf, ps)
        if _factored(shape):
            st = {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                  "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                    device=dev)}
        else:
            st = {"v": torch.zeros(shape, dtype=F32, device=dev)}
        set_path(fac, leaf.path, st)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "fac": fac}


def opt_state_axes(param_axes, ocfg: OptimConfig, params=None
                   ) -> Dict[str, Any]:
    """The reference's axes of the stacked state: a stacked leaf's axes
    are ('layers',) + its layer's. Needs the parameter tree (its
    `LayerStack` periods)."""
    if params is None:
        raise ValueError("Adafactor's state axes follow the reference's "
                         "stacking: pass the parameter tree")
    fac: Dict[str, Any] = {}
    for leaf in stacked_leaves(params):
        ax = tuple(get_path(param_axes, leaf.port_paths[0]))
        if leaf.stacked:
            ax = ("layers",) + ax
        set_path(fac, leaf.path, {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
                 if len(ax) >= 2 else {"v": ax})
    return {"step": (), "fac": fac}


def _vhat(vr, vc):
    denom = torch.clamp(vr.mean(-1, keepdim=True), min=_EPS1)
    return (vr[..., None] / denom[..., None]) * vc[..., None, :]


def _leaf_updates(st: Dict, gfs: List[torch.Tensor], stacked: bool,
                  beta2) -> List[torch.Tensor]:
    """u of every layer of one reference leaf (its state updated)."""
    per_layer_rank = gfs[0].dim()
    if stacked and per_layer_rank >= 2:
        # the reference's means stay within a layer: slice by slice
        out = []
        for r, gf in enumerate(gfs):
            g2 = torch.square(gf) + _EPS1
            vr_r, vc_r = select0(st["vr"], r), select0(st["vc"], r)
            vr = beta2 * vr_r + (1 - beta2) * g2.mean(-1)
            vc = beta2 * vc_r + (1 - beta2) * g2.mean(-2)
            vr_r.copy_(vr)
            vc_r.copy_(vc)
            out.append(gf / torch.sqrt(_vhat(vr, vc) + 1e-30))
        return out
    gf = torch.stack(gfs) if stacked else gfs[0]
    g2 = torch.square(gf) + _EPS1
    if "vr" in st:
        st["vr"].copy_(beta2 * st["vr"] + (1 - beta2) * g2.mean(-1))
        st["vc"].copy_(beta2 * st["vc"] + (1 - beta2) * g2.mean(-2))
        u = gf / torch.sqrt(_vhat(st["vr"], st["vc"]) + 1e-30)
    else:
        st["v"].copy_(beta2 * st["v"] + (1 - beta2) * g2)
        u = gf / torch.sqrt(st["v"] + 1e-30)
    return list(u) if stacked else [u]


def apply_updates(params, grads, opt_state, ocfg: OptimConfig, lr,
                  grad_scale: float = 1.0
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One Adafactor step, in place (parameters and state); returns
    them. ``grads`` as in `adamw.apply_updates`."""
    ps = leaves(params)
    gs = leaves(grads) if not isinstance(grads, list) else grads
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    dev = ps[0].device
    lr = torch.as_tensor(lr, dtype=F32, device=dev)
    step = opt_state["step"] + 1
    gnorm_sq = []
    with torch.no_grad():
        beta2 = 1.0 - torch.pow(step.to(F32), -0.8)     # t^-0.8 schedule
        for leaf in stacked_leaves(params):
            gfs = [gs[i].to(F32) * grad_scale for i in leaf.index]
            gnorm_sq.append(torch.sum(torch.stack(
                [torch.sum(torch.square(g)) for g in gfs])))
            us = _leaf_updates(get_path(opt_state["fac"], leaf.path), gfs,
                               leaf.stacked, beta2)
            del gfs
            n = sum(u.numel() for u in us)
            ms = torch.sum(torch.stack([torch.sum(torch.square(u))
                                        for u in us])) / n
            rms = torch.sqrt(ms + 1e-30)
            scale = torch.clamp(rms / _CLIP, min=1.0)
            for i, u in zip(leaf.index, us):
                p = ps[i]
                pf = p.to(F32)
                p_new = pf - lr * (u / scale + ocfg.weight_decay * pf)
                p.copy_(p_new)
        gnorm = torch.sqrt(torch.sum(torch.stack(gnorm_sq)))
    return params, dict(opt_state, step=step), {"grad_norm": gnorm,
                                                "lr": lr}
