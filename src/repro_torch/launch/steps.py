"""Step builders: train / prefill / decode, with shardings resolved from
logical axes (answers `src/repro/launch/steps.py`).

train_step = microbatch gradient accumulation (remat inside the model's
layer loop) → gradient codec (optim.compress) → AdamW | Adafactor, the
parameters and the optimizer state updated in place (the reference
donates its state to the jitted step). The gradients autograd returns
are the accumulator: the first microbatch's decoded gradient is it
(equal to the reference's ``0 + g``), the next ones add into it, so no
zero-initialised f32 tree exists; in f32 at ``n_micro`` = 1 under codec
'none' it is autograd's own tensor. The state's and the batch's
shardings come from the logical-axis rules over the trainer's mesh
(`launch/mesh.py::make_local_mesh`); on one device they place nothing.
The int8 codec scales each of the reference's stacked leaves as one
tensor (`optim/compress.py`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.configs.base import (ModelConfig, OptimConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.models import api, transformer as T
from repro_torch.optim import compress, schedule
from repro_torch.optim.tree import as_dict, leaves, stacked_leaves
from repro_torch.sharding.axes import (constrain, current_act_rules,
                                       mesh_shape, resolve_spec,
                                       tree_shardings)

F32 = torch.float32


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def abstract_state(cfg: ModelConfig, ocfg: OptimConfig):
    """(state on the meta device — shapes and dtypes, no storage — and
    its logical axes), the reference's ``jax.eval_shape``."""
    return concrete_state(None, cfg, ocfg, device="meta")


def concrete_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                   ocfg: OptimConfig, device=None):
    """({"params", "opt"}, their logical axes): parameters drawn from
    ``generator`` on ``device`` (the generator's by default)."""
    params, axes = T.init_params(generator, cfg, device=device)
    opt = optim.init_opt_state(params, ocfg)
    return ({"params": params, "opt": opt},
            {"params": axes, "opt": optim.opt_state_axes(axes, ocfg,
                                                         params)})


def _shaped(tree):
    """A tree whose leaves answer ``.shape``: the state's tensors, or a
    spec's (shape, dtype) as a meta tensor."""
    if isinstance(tree, dict):
        return {k: _shaped(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return torch.empty(tree[0], dtype=tree[1], device="meta")
    return tree


def state_shardings(state_axes, state, mesh):
    """The state's TensorSharding tree (the current profile's rules)."""
    return tree_shardings(state_axes, as_dict(state), mesh)


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    specs, axes = api.input_specs(cfg, shape)
    out = {group: tree_shardings(axes[group], _shaped(specs[group]), mesh,
                                 current_act_rules())
           for group in specs}
    return specs, out


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def num_microbatches(shape: ShapeConfig, mesh, tcfg: TrainConfig) -> int:
    """Profile-aware: dp = however many ways act_batch shards the global
    batch under the current rules (1 on a one-device mesh: microbatches
    of ``microbatch_per_device``)."""
    if mesh is None:
        return 1
    spec = resolve_spec(("act_batch",), (shape.global_batch,), mesh,
                        current_act_rules())
    sizes = mesh_shape(mesh)
    dp = 1
    used = spec[0] if len(spec) else None
    if used is not None:
        for a in ((used,) if isinstance(used, str) else used):
            dp *= sizes[a]
    per_micro = dp * tcfg.microbatch_per_device
    return max(1, shape.global_batch // max(per_micro, 1))


def make_train_step(cfg: ModelConfig, ocfg: OptimConfig, tcfg: TrainConfig,
                    shape: ShapeConfig, mesh=None):
    """train_step(state, batch) → (state, metrics): the state's tensors
    updated in place; the metrics 0-dim f32 tensors (loss, ce, the MoE
    aux means, grad_norm, lr)."""
    n_micro = num_microbatches(shape, mesh, tcfg)
    acc_dtype = torch.bfloat16 if ocfg.compress_grads == "bf16" else F32

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        ps = leaves(params)
        stacks = [leaf.index for leaf in stacked_leaves(params)]
        bsz = batch["tokens"].shape[0]
        mb = bsz // n_micro
        acc = [None] * len(ps)
        loss_acc = torch.zeros((), dtype=F32, device=ps[0].device)
        metr_acc: Dict[str, torch.Tensor] = {}
        for i in range(n_micro):
            micro = {k: constrain(v[i * mb:(i + 1) * mb], mesh, "act_batch",
                                  *([None] * (v.dim() - 1)))
                     for k, v in batch.items()}
            loss, metrics = T.loss_fn(params, micro, cfg, mesh, tcfg.remat,
                                      tcfg.label_smoothing)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(ps, grads)]
            grads = compress.decode(
                compress.encode(grads, ocfg.compress_grads, groups=stacks),
                ocfg.compress_grads)
            for j, g in enumerate(grads):
                g = g.to(acc_dtype)
                if acc[j] is None:
                    acc[j] = g                    # the reference's 0 + g
                else:
                    acc[j].add_(g)
            del grads
            loss_acc = loss_acc + loss.detach()
            for k, v in metrics.items():
                metr_acc[k] = metr_acc.get(k, 0.0) + v.detach()
        inv = 1.0 / n_micro
        metr = {k: v * inv for k, v in metr_acc.items()}
        lr = schedule.learning_rate(ocfg, state["opt"]["step"] + 1)
        # 1/n_micro folded into the per-leaf optimizer cast (no f32 tree)
        params, opt, stats = optim.apply_updates(params, acc, state["opt"],
                                                 ocfg, lr, grad_scale=inv)
        del acc
        metr.update(stats)
        metr["loss"] = loss_acc * inv
        return {"params": params, "opt": opt}, metr

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, mesh, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    def decode_step(params, cache, batch):
        return T.decode_step(params, cache, batch["tokens"], cfg, mesh)
    return decode_step
