"""Architecture / shape / problem registry: ``--arch <id>`` resolution
(answers `src/repro/configs/registry.py`).

``get_arch(id)`` returns the full-size ModelConfig; ``smoke_config(id)``
returns a reduced same-family variant for CPU smoke tests; ``cells()``
enumerates the (arch × shape) dry-run grid with skip reasons;
``PROBLEMS`` holds the paper's three problems under the reference's
names. The full-shape configurations the card runs
(`paper_kmedoid.TINY_IMAGENET`, `paper_kcover.KOSARAK`) stay module
constants, not registry names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.configs.base import (
    FrontendConfig, ModelConfig, MoEConfig, SHAPES, SHAPES_BY_NAME,
    ShapeConfig, SSMConfig, SubmodularConfig,
)

from repro_torch.configs import (  # noqa: E402  (import order is the registry)
    mamba2_1p3b, qwen2_7b, smollm_135m, h2o_danube3_4b, qwen2p5_3b,
    llama4_maverick, qwen3_moe_30b, jamba_v01_52b, seamless_m4t_v2,
    llava_next_mistral_7b, paper_kcover, paper_kdom, paper_kmedoid,
)

ARCHS: Dict[str, ModelConfig] = {
    "mamba2-1.3b": mamba2_1p3b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
    "qwen2.5-3b": qwen2p5_3b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b.CONFIG,
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_v2.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
}

PROBLEMS: Dict[str, SubmodularConfig] = {
    "paper-kcover": paper_kcover.CONFIG,
    "paper-kdom": paper_kdom.CONFIG,
    "paper-kmedoid": paper_kmedoid.CONFIG,
}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown --arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


# ---------------------------------------------------------------------------
# Cell applicability
# ---------------------------------------------------------------------------


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if (arch, shape) is a valid dry-run cell, else the skip reason."""
    if shape.name == "long_500k":
        if not cfg.is_subquadratic:
            return ("pure full-attention arch: long_500k needs sub-quadratic "
                    "attention (skip per assignment; see DESIGN.md §7)")
    if shape.kind in ("decode", "prefill") and cfg.is_encdec and shape.name == "long_500k":
        return "enc-dec audio backbone: 500k-frame decode is out of scope"
    return None


def cells(include_skipped: bool = False) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (arch_id, shape_name, skip_reason) for the full 10×4 grid."""
    for arch_id, cfg in ARCHS.items():
        for shape in SHAPES:
            reason = shape_skip_reason(cfg, shape)
            if reason is None or include_skipped:
                yield arch_id, shape.name, reason


# ---------------------------------------------------------------------------
# Reduced smoke variants (same family, tiny dims) — CPU-runnable
# ---------------------------------------------------------------------------


def smoke_config(arch_id: str) -> ModelConfig:
    cfg = get_arch(arch_id)
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        dtype="float32",        # CPU smoke runs in f32 for tight tolerances
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 2
    if cfg.moe is not None:
        top_k = min(cfg.moe.top_k, 2)
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=top_k,
            d_expert=64 if cfg.moe.d_expert else 0,
            capacity_factor=4 / top_k)  # no-drop capacity → exact routing

    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=8)
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.frontend is not None:
        kw["frontend"] = dataclasses.replace(
            cfg.frontend,
            num_embeds=(8 if cfg.frontend.num_embeds else 0), embed_dim=32)
    # keep hybrid interleave representative: 4 layers must include the attn
    # layer (offset 4 would fall outside 4 layers) and a MoE layer.
    if cfg.attn_every > 1:
        kw["attn_every"] = 4
        kw["attn_offset"] = 1
    return cfg.replace(**kw)


def smoke_shape(shape_name: str) -> ShapeConfig:
    """Reduced shapes matching the full cells' kind."""
    full = get_shape(shape_name)
    seq = {"train_4k": 32, "prefill_32k": 64, "decode_32k": 64,
           "long_500k": 128}[shape_name]
    return ShapeConfig(full.name, full.kind, seq, 4 if full.global_batch > 1 else 1)
