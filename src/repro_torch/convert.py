"""Carry the reference's inputs and state into the port and back.

There are no model weights in this system: the data is the weights. What
crosses between the packages is numpy: pools (ids, payloads, valid),
`Solution` fields, `RuleState` rows, constraints (categories,
capacities, costs, budgets) and streaming state (`SieveState`,
`WindowState`), so a stream stopped in one package continues in the
other. The model zoo's random weights cross too: the reference's
parameter pytree and its prefill cache (period-stacked under
``blocks/pos{i}`` with a leading repeats axis) become the port's
per-layer modules and cache entries (`model_params_to_torch`,
`model_cache_to_torch`), so a test holds both packages' models on the
same weights; and a training state ``{"params", "opt"}`` crosses both
ways (`train_state_to_torch`, `train_state_to_numpy`): AdamW's moments
and master copy unstacked into the port's per-layer mirror of the
parameters, Adafactor's state as the reference keeps it (stacked,
keyed by its leaf paths; see optim/adafactor.py). `np.asarray` reads
the reference's arrays without importing its framework, so a test can
hand both packages the same state mid-run.

Type mapping: uint32 bitmap words ↔ int32 tensors holding the same bit
patterns (the port's word representation, see kernels/rules.py); int32
ids/evals ↔ int64; f32 and bool unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import constraints as C
from repro_torch.core.greedy import Solution
from repro_torch.core.objective import RuleState
from repro_torch.kernels import rules as R
from repro_torch.models.layers import LayerStack, Params
from repro_torch.models.transformer import period_of
from repro_torch.optim.tree import leaves, set_path, stacked_leaves, tree_map
from repro_torch.runtime.device import DeviceLike, resolve_device
from repro_torch.streaming.sieve import SieveState
from repro_torch.streaming.window import WindowState


def to_torch(x, device: DeviceLike = None):
    """numpy-like → tensor on `device`; uint32 words become int32 bit
    patterns, int32 ids widen to int64; None passes through."""
    if x is None:
        return None
    a = np.array(x)                  # a writable copy for torch
    if a.dtype == np.uint32:
        return R.to_words(a).to(resolve_device(device))
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=resolve_device(device))


def to_numpy(t, dtype=None):
    """tensor → numpy, optionally cast (int32 words → np.uint32, …)."""
    if t is None:
        return None
    a = t.detach().cpu().numpy()
    return a.astype(dtype) if dtype is not None else a


def solution_to_torch(sol: Any, device: DeviceLike = None) -> Solution:
    """A reference `Solution` (any object with ids/payloads/valid/value/
    evals arrays) → the port's Solution."""
    return Solution(*(to_torch(getattr(sol, f), device)
                      for f in ("ids", "payloads", "valid", "value",
                                "evals")))


def solution_to_numpy(sol: Solution, bitmap: bool = False
                      ) -> Dict[str, np.ndarray]:
    """The port's Solution → numpy fields in the reference's dtypes."""
    return {"ids": to_numpy(sol.ids, np.int32),
            "payloads": to_numpy(sol.payloads,
                                 np.uint32 if bitmap else None),
            "valid": to_numpy(sol.valid),
            "value": to_numpy(sol.value),
            "evals": to_numpy(sol.evals, np.int32)}


def state_to_torch(state: Any, device: DeviceLike = None) -> RuleState:
    """A reference `RuleState` → the port's RuleState (same batch shape)."""
    return RuleState(*(to_torch(getattr(state, f), device)
                       for f in ("ground", "gvalid", "row", "base",
                                 "n_eff")))


def state_to_numpy(state: RuleState, bitmap: bool = False
                   ) -> Dict[str, np.ndarray]:
    """The port's RuleState → numpy fields in the reference's dtypes."""
    return {"ground": to_numpy(state.ground),
            "gvalid": to_numpy(state.gvalid),
            "row": to_numpy(state.row, np.uint32 if bitmap else None),
            "base": to_numpy(state.base),
            "n_eff": to_numpy(state.n_eff)}


def constraint_to_torch(con: Any, device: DeviceLike = None):
    """A reference constraint — PartitionMatroid, Knapsack, Composite or
    KnapsackSpec, told apart by class name and read as numpy — → the
    port's constraint of the same kind and shape on `device`."""
    kind = type(con).__name__
    if kind == "Composite":
        return C.Composite(tuple(constraint_to_torch(p, device)
                                 for p in con.parts))
    if kind == "PartitionMatroid":
        return C.PartitionMatroid(to_torch(con.categories, device),
                                  to_torch(con.capacities, device))
    if kind == "Knapsack":
        return C.Knapsack(to_torch(np.asarray(con.costs, np.float32), device),
                          to_torch(np.asarray(con.budget, np.float32),
                                   device))
    if kind == "KnapsackSpec":
        return C.KnapsackSpec(to_torch(np.asarray(con.costs, np.float32),
                                       device), float(con.budget))
    raise TypeError(f"no port of the constraint {kind!r}")


def sieve_state_to_torch(state: Any, device: DeviceLike = None
                         ) -> SieveState:
    """A reference `SieveState` (one sieve or stacked) → the port's:
    rows (uint32 words as int32), counts and exponents int32 (as the
    stream filter takes them), ids and evals int64, spent f32 or None."""
    def i32(x):
        return torch.as_tensor(np.array(x, np.int32),
                               device=resolve_device(device))

    return SieveState(to_torch(state.rows, device),
                      to_torch(np.asarray(state.values, np.float32), device),
                      i32(state.counts), i32(state.expos),
                      to_torch(np.asarray(state.m_max, np.float32), device),
                      to_torch(state.ids, device),
                      to_torch(state.payloads, device),
                      to_torch(state.evals, device),
                      None if state.spent is None
                      else to_torch(np.asarray(state.spent, np.float32),
                                    device))


def window_state_to_torch(wstate: Any, device: DeviceLike = None
                          ) -> WindowState:
    """A reference `WindowState` → the port's (stacked checkpoint states
    on `device`; ages and the arrivals seen on the host)."""
    return WindowState(sieve_state_to_torch(wstate.states, device),
                       np.asarray(wstate.ages).astype(np.int64),
                       int(np.asarray(wstate.seen)))


def _float(a, device: torch.device) -> torch.Tensor:
    """A float array (f32, or bf16 as ml_dtypes stores it) → a tensor of
    the same dtype and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _params_node(tree: Dict, device: torch.device, repeat=None) -> Params:
    """A nested dict of arrays → a `Params` tree; ``repeat`` takes one
    entry of every array's leading (stacked) axis."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _params_node(v, device, repeat)
        else:
            out[k] = _float(np.asarray(v) if repeat is None
                            else np.asarray(v)[repeat], device)
    return Params(**out)


def model_params_to_torch(params_np: Dict, cfg, device: DeviceLike = None
                          ) -> Params:
    """The reference's model parameters (a pytree of arrays, the blocks
    stacked per period position) → the port's parameter tree: layer
    r·P + i takes ``blocks/pos{i}[r]``, encoder layer r
    ``encoder/blocks/pos0[r]``."""
    dev = resolve_device(device)
    period = period_of(cfg)
    blocks = params_np["blocks"]
    top = {k: _params_node(params_np[k], dev)
           for k in ("embed", "final_norm", "projector") if k in params_np}
    top["blocks"] = LayerStack(
        (_params_node(blocks[f"pos{i % period}"], dev, i // period)
         for i in range(cfg.num_layers)), period)
    if "encoder" in params_np:
        enc = params_np["encoder"]
        top["encoder"] = Params(
            blocks=LayerStack(
                _params_node(enc["blocks"]["pos0"], dev, r)
                for r in range(cfg.encoder_layers)),
            final_norm=_params_node(enc["final_norm"], dev))
    return Params(**top)


def model_cache_to_torch(cache_np: Dict, cfg, device: DeviceLike = None
                         ) -> Dict:
    """The reference's decode cache (``layers/pos{i}/<buffer>`` stacked
    over the repeats, an int32 ``index``) → the port's per-layer cache."""
    dev = resolve_device(device)
    period = period_of(cfg)
    layers = [{k: _float(np.asarray(v)[i // period], dev)
               for k, v in cache_np["layers"][f"pos{i % period}"].items()}
              for i in range(cfg.num_layers)]
    return {"layers": layers, "index": int(np.asarray(cache_np["index"]))}


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host (bf16 as its exact f32 values)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def stack_to_numpy(tree, layout) -> Dict:
    """The leaves of `tree` (a parameter tree or its mirror) in the
    reference's layout: each of `layout`'s leaves (`stacked_leaves` of
    the parameters) stacked over its repeats."""
    ls = leaves(tree)
    out: Dict[str, Any] = {}
    for leaf in layout:
        arrs = [_host(ls[i]) for i in leaf.index]
        set_path(out, leaf.path, np.stack(arrs) if leaf.stacked else arrs[0])
    return out


def model_params_to_numpy(params: Params) -> Dict:
    """The port's parameter tree → the reference's stacked numpy tree
    (the inverse of `model_params_to_torch`)."""
    return stack_to_numpy(params, stacked_leaves(params))


def _nested(tree, fn):
    if isinstance(tree, dict):
        return {k: _nested(v, fn) for k, v in tree.items()}
    return fn(tree)


def train_state_to_torch(state_np: Dict, cfg, ocfg, device: DeviceLike = None
                         ) -> Dict:
    """The reference's train state ``{"params", "opt"}`` (numpy) → the
    port's: the parameters per layer; AdamW's ``m``, ``v`` (and
    ``master``) as the parameters' mirror (`optim.tree.tree_map`),
    Adafactor's ``fac`` as it stands; ``step`` an int32 tensor."""
    dev = resolve_device(device)
    params = model_params_to_torch(state_np["params"], cfg, dev)
    opt_np = state_np["opt"]
    opt: Dict[str, Any] = {"step": torch.tensor(
        int(np.asarray(opt_np["step"])), dtype=torch.int32, device=dev)}
    if ocfg.name == "adafactor":
        opt["fac"] = _nested(opt_np["fac"], lambda a: _float(a, dev))
    else:
        for key in ("m", "v", "master"):
            if key in opt_np:
                opt[key] = tree_map(
                    lambda t: t.detach(),
                    model_params_to_torch(opt_np[key], cfg, dev))
    return {"params": params, "opt": opt}


def train_state_to_numpy(state: Dict, cfg, ocfg) -> Dict:
    """The port's train state → the reference's layout (numpy, bf16 as
    f32 values), for a comparison leaf by leaf."""
    params = state["params"]
    if len(params["blocks"]) != cfg.num_layers or (
            params["blocks"].period != period_of(cfg)):
        raise ValueError(f"the parameters are not {cfg.name}'s layers")
    layout = stacked_leaves(params)
    opt = state["opt"]
    out_opt: Dict[str, Any] = {"step": np.asarray(int(opt["step"]),
                                                  np.int32)}
    if ocfg.name == "adafactor":
        out_opt["fac"] = _nested(opt["fac"], _host)
    else:
        for key in ("m", "v", "master"):
            if key in opt:
                out_opt[key] = stack_to_numpy(opt[key], layout)
    return {"params": stack_to_numpy(params, layout), "opt": out_opt}
