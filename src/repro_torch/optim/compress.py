"""Gradient compression codecs for the data-parallel reduction (answers
`src/repro/optim/compress.py`).

  * 'bf16'  — each microbatch gradient cast to bf16 before accumulation
  * 'int8'  — per-tensor absmax-scaled int8, stochastic rounding when a
              ``generator`` is given (unbiased), round to nearest without

Keyless, every codec equals the reference's bit for bit (the train step
calls it keyless). A keyed int8 call draws its rounding noise from a
`torch.Generator`, one leaf after another, where the reference splits a
``jax.random`` key per leaf: other noise, the same distribution (ROADMAP
§C, D3).

A gradient tree is a tensor, a list or a dict of them; an int8 leaf is
encoded as a (q int8, scale f32) tuple. The reference's "per-tensor"
scale is its stacked leaf's: one absmax over all the repeats of a
period position. ``groups`` (lists of positions in a gradient list, as
`tree.stacked_leaves` gives them) lets the per-layer gradients share
their stack's scale.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

F32 = torch.float32


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def encode(grads, method: str, generator: Optional[torch.Generator] = None,
           groups: Optional[List[List[int]]] = None):
    if method == "none":
        return grads
    if method == "bf16":
        return _map(lambda g: g.to(torch.bfloat16), grads)
    if method == "int8":
        if groups is None:
            return _map(lambda g: _quantize_sr(g, generator), grads)
        out = [None] * len(grads)
        for group in groups:
            amax = torch.stack([grads[i].to(F32).abs().max()
                                for i in group]).max()
            for i in group:
                out[i] = _quantize_sr(grads[i], generator, amax)
        return out
    raise ValueError(method)


def decode(grads, method: str):
    if method == "none":
        return grads
    if method == "bf16":
        return _map(lambda g: g.to(F32), grads)
    if method == "int8":
        return _map(lambda t: t[0].to(F32) * t[1], grads)
    raise ValueError(method)


def _quantize_sr(g: torch.Tensor, generator: Optional[torch.Generator],
                 amax: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) of one tensor; ``amax``: its stack's absmax."""
    gf = g.to(F32)
    if amax is None:
        amax = gf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    x = gf / scale
    if generator is not None:
        x = x + (torch.rand(g.shape, generator=generator, device=g.device,
                            dtype=F32) - 0.5)
    q = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return q, scale
