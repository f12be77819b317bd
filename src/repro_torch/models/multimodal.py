"""Modality frontends — stubs (answers `src/repro/models/multimodal.py`).

The [audio]/[vlm] architectures specify the transformer BACKBONE only;
the vision tower / speech feature extractor is replaced by precomputed
embeddings supplied with the batch. For tests and serving this module
synthesizes embeddings of unit norm from a torch.Generator.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def frontend_num_embeds(cfg: ModelConfig, seq_len: int) -> int:
    """num_embeds == 0 means 'track the sequence length' (audio frames)."""
    fe = cfg.frontend
    if fe is None:
        raise ValueError(f"{cfg.name} has no modality frontend")
    return fe.num_embeds if fe.num_embeds else seq_len


def synth_patches(generator: torch.Generator, cfg: ModelConfig, batch: int,
                  seq_len: int, dtype=torch.float32) -> torch.Tensor:
    """Stand-in for CLIP/w2v-BERT outputs (unit norm), on the
    generator's device."""
    n = frontend_num_embeds(cfg, seq_len)
    x = torch.randn((batch, n, cfg.frontend.embed_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x.to(dtype)
