"""LR schedules: linear warmup into cosine / linear / constant / wsd
(answers `src/repro/optim/schedule.py`). Computed in float32 tensors, as
the reference computes in ``jnp.float32``: the same roundings a step."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimConfig

F32 = torch.float32


def learning_rate(ocfg: OptimConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor; the result lies
    on the tensor's device)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = torch.as_tensor(step, device=dev).to(F32)
    warm = torch.tensor(float(max(ocfg.warmup_steps, 1)), dtype=F32,
                        device=dev)
    total = torch.tensor(float(max(ocfg.total_steps, 1)), dtype=F32,
                         device=dev)
    frac = torch.clamp((s - warm) / torch.clamp(total - warm, min=1.0),
                       0.0, 1.0)
    if ocfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif ocfg.schedule == "linear":
        decay = 1.0 - frac
    elif ocfg.schedule == "wsd":          # warmup-stable-decay (10% tail)
        decay = torch.where(frac < 0.9, 1.0, (1.0 - frac) / 0.1)
    else:
        decay = torch.ones((), dtype=F32, device=dev)
    warmup = torch.clamp(s / warm, 0.0, 1.0)
    return ocfg.lr * warmup * decay
