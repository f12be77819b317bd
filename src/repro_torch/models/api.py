"""Model-zoo facade: input specs per (arch × shape) cell and batch axes
(answers `src/repro/models/api.py`).

``input_specs(cfg, shape)`` gives the (shape, dtype) of every model
input of that cell with its logical axes; ``synth_batch`` draws a
concrete batch of those shapes from a torch.Generator.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.multimodal import frontend_num_embeds, synth_patches

I64 = torch.int64


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """(shape, dtype) of a train/prefill/decode batch: tokens/labels
    (+ frontend embeds)."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind == "decode":
        specs["tokens"] = ((b, 1), I64)
    else:
        specs["tokens"] = ((b, s), I64)
        if shape.kind == "train":
            specs["labels"] = ((b, s), I64)
    if cfg.frontend is not None and shape.kind != "decode":
        n = frontend_num_embeds(cfg, s)
        key = "frames" if cfg.is_encdec else "patches"
        specs[key] = ((b, n, cfg.frontend.embed_dim), dtype_of(cfg))
    return specs


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Logical activation axes per batch entry."""
    axes: Dict[str, Any] = {"tokens": ("act_batch", None)}
    if shape.kind == "train":
        axes["labels"] = ("act_batch", None)
    if cfg.frontend is not None and shape.kind != "decode":
        key = "frames" if cfg.is_encdec else "patches"
        axes[key] = ("act_batch", None, None)
    return axes


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(specs, logical_axes) for every input of the (arch × shape) cell:
    train/prefill → {'batch': …}; decode → {'batch': …, 'cache': …}."""
    specs: Dict[str, Any] = {"batch": batch_specs(cfg, shape)}
    axes: Dict[str, Any] = {"batch": batch_axes(cfg, shape)}
    if shape.kind == "decode":
        enc_len = shape.seq_len if cfg.is_encdec else 0
        specs["cache"], axes["cache"] = T.cache_spec(
            cfg, shape.global_batch, shape.seq_len, enc_len)
    return specs, axes


def synth_batch(generator: torch.Generator, cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """A random batch of batch_specs' shapes on the generator's device."""
    dev = generator.device
    specs = batch_specs(cfg, shape)
    out = {"tokens": torch.randint(0, cfg.vocab_size, specs["tokens"][0],
                                   generator=generator, device=dev)}
    if "labels" in specs:
        out["labels"] = torch.randint(0, cfg.vocab_size, specs["labels"][0],
                                      generator=generator, device=dev)
    for key in ("patches", "frames"):
        if key in specs:
            out[key] = synth_patches(generator, cfg, shape.global_batch,
                                     shape.seq_len, dtype=specs[key][1])
    return out
