"""AdamW with decoupled weight decay, global-norm clipping, configurable
moment dtypes and an optional f32 master copy (answers
`src/repro/optim/adamw.py`).

The moments (and the master copy) mirror the parameter tree
(`tree.tree_map`: dicts and lists), one tensor a parameter. The update
runs in place, parameter by parameter, under ``torch.no_grad``: no
second tree of f32 gradients, moments or parameters is ever
materialized (at qwen2.5-3b's width one more f32 tree is 12.3 GB). The
reference's operations and their order are kept, so each rounding is
the reference's: ``grad_scale · clip`` folded into the per-leaf f32
cast, ``b1·m + (1 − b1)·g``, ``b2·v + ((1 − b2)·g)·g``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import OptimConfig
from repro_torch.optim.tree import leaves, tree_map

F32 = torch.float32


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_opt_state(params, ocfg: OptimConfig) -> Dict[str, Any]:
    mdt = _dtype(ocfg.moment_dtype)
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    if ocfg.master_dtype:
        state["master"] = tree_map(
            lambda p: p.detach().to(_dtype(ocfg.master_dtype)).clone(),
            params)
    return state


def opt_state_axes(param_axes, ocfg: OptimConfig, params=None
                   ) -> Dict[str, Any]:
    """Logical axes for the optimizer state (moments shard like params)."""
    state = {"step": (), "m": param_axes, "v": param_axes}
    if ocfg.master_dtype:
        state["master"] = param_axes
    return state


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.to(F32)))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([_sq_sum(x)
                                             for x in leaves(tree)])))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


def apply_updates(params, grads, opt_state, ocfg: OptimConfig, lr,
                  grad_scale: float = 1.0
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params`` and the state's tensors are
    updated and returned. ``grads`` is a tree (or a list in `leaves`
    order) of the parameters' gradients, None for an unused one (a zero
    gradient). ``grad_scale`` folds the 1/n_micro averaging into the
    per-leaf f32 cast."""
    ps = leaves(params)
    gs = leaves(grads) if not isinstance(grads, list) else grads
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    dev = ps[0].device
    lr = torch.as_tensor(lr, dtype=F32, device=dev)
    step = opt_state["step"] + 1
    b1, b2 = ocfg.betas
    with torch.no_grad():
        gnorm = global_norm(gs) * grad_scale
        if ocfg.grad_clip > 0:
            clip = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                               max=1.0)
        else:
            clip = torch.ones((), dtype=F32, device=dev)
        stepf = step.to(F32)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        g_mul = grad_scale * clip
        ms, vs = leaves(opt_state["m"]), leaves(opt_state["v"])
        masters = (leaves(opt_state["master"]) if "master" in opt_state
                   else [None] * len(ps))
        for p, g, m, v, mp in zip(ps, gs, ms, vs, masters):
            base = p if mp is None else mp
            gf = g.to(F32) * g_mul
            m_new = m.mul_(b1) if m.dtype == F32 else m.to(F32) * b1
            m_new.add_(gf * (1 - b1))
            v_new = v.mul_(b2) if v.dtype == F32 else v.to(F32) * b2
            v_new.add_((gf * (1 - b2)).mul_(gf))
            del gf
            if m_new is not m:
                m.copy_(m_new)
            if v_new is not v:
                v.copy_(v_new)
            denom = torch.sqrt(v_new / bc2).add_(ocfg.eps)
            del v_new
            upd = (m_new / bc1).div_(denom)
            del m_new, denom
            pf = base.to(F32)
            upd.add_(ocfg.weight_decay * pf)
            upd.mul_(lr)
            if base.dtype == F32:
                base.sub_(upd)               # pf - lr·step_vec, in place
            else:
                base.copy_(pf - upd)
            if mp is not None:
                p.copy_(mp)                  # the f32 master, cast
    new_state = dict(opt_state, step=step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
