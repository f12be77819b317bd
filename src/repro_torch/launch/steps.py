"""Step builders, the serving half (answers `src/repro/launch/steps.py:
157-174`): ``make_prefill_step`` and ``make_decode_step`` wrap the
model's entry points in the signatures the serving driver calls. The
train step, the state builders and the shardings come with the trainer.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, mesh, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    def decode_step(params, cache, batch):
        return T.decode_step(params, cache, batch["tokens"], cfg, mesh)
    return decode_step
