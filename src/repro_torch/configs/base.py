"""Config dataclasses (answers `src/repro/configs/base.py`, whole).

Every config is a frozen dataclass, so configs hash and compare by
value. The model zoo is one flexible ``ModelConfig``: per-layer mixer
('attn' | 'mamba' | 'none') and FFN ('dense' | 'moe' | 'none') patterns
cover the dense, MoE, SSM and hybrid families; ``encoder_layers > 0``
selects encoder–decoder; ``frontend`` a (stubbed) modality frontend that
supplies precomputed embeddings. The port runs no model yet: these are
the registry's records (`configs/registry.py`), field for field the
reference's, with the same analytic parameter counts. ``SubmodularConfig``
describes the paper's own problems, which the port runs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k Mixture-of-Experts FFN."""

    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 0            # expert hidden dim (0 → use model d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    router_z_weight: float = 1e-3
    num_shared_experts: int = 0  # always-on experts (llama4-style shared)
    token_exchange: bool = False # dispatch tokens (all-to-all) instead of
                                 # gathering expert weights


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer."""

    d_state: int = 128
    head_dim: int = 64           # SSD head dim (P)
    expand: int = 2              # d_inner = expand * d_model
    n_groups: int = 1            # B/C groups (GVA-style)
    conv_width: int = 4
    chunk_size: int = 256        # SSD chunk length (matmul granularity)
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: precomputed patch/frame embeddings of
    shape (batch, num_embeds, embed_dim), linearly projected into
    d_model; the [audio]/[vlm] entries specify the transformer backbone
    only."""

    kind: str = "vision"         # 'vision' | 'audio'
    num_embeds: int = 576        # patches per image / frames per utterance
    embed_dim: int = 1024        # frontend output dim (pre-projection)


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # one of _FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    sliding_window: int = 0      # 0 → full attention; >0 → SWA window
    swa_pattern: int = 1         # 1 → every layer SWA; n → 1 full per n layers
    tie_embeddings: bool = False

    # Per-layer structure ----------------------------------------------------
    # mixer: 'attn' everywhere by default; attn_every=n → layer i uses 'attn'
    # iff (i % n) == attn_offset, else 'mamba' (Jamba-style interleave).
    attn_every: int = 1
    attn_offset: int = 0
    # ffn: 'dense' by default; moe_every=n → layer i uses MoE iff
    # (i % n) == moe_offset.  d_ff == 0 → no FFN at all (pure-Mamba blocks).
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    moe_offset: int = 0
    ssm: Optional[SSMConfig] = None

    # Encoder–decoder --------------------------------------------------------
    encoder_layers: int = 0      # >0 → enc-dec; decoder = num_layers
    encoder_seq_len: int = 0     # frontend/encoder sequence length for enc-dec

    # Modality frontend (stub) ----------------------------------------------
    frontend: Optional[FrontendConfig] = None

    # Numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"      # activation/computation dtype
    param_dtype: str = "float32"  # master param dtype

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        assert self.family in _FAMILIES, self.family

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def mixer_kind(self, layer: int) -> str:
        """'attn' | 'mamba' for decoder layer `layer`."""
        if self.ssm is None:
            return "attn"
        if self.num_heads == 0:
            return "mamba"       # attention-free (pure SSM)
        return "attn" if (layer % self.attn_every) == self.attn_offset else "mamba"

    def ffn_kind(self, layer: int) -> str:
        """'dense' | 'moe' | 'none' for decoder layer `layer`."""
        if self.d_ff == 0 and self.moe is None:
            return "none"
        if self.moe is not None and (layer % self.moe_every) == self.moe_offset:
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    def layer_is_swa(self, layer: int) -> bool:
        if self.sliding_window <= 0:
            return False
        return (layer % self.swa_pattern) != (self.swa_pattern - 1) if self.swa_pattern > 1 else True

    def mixer_pattern(self) -> Tuple[str, ...]:
        return tuple(self.mixer_kind(i) for i in range(self.num_layers))

    def ffn_pattern(self) -> Tuple[str, ...]:
        return tuple(self.ffn_kind(i) for i in range(self.num_layers))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return all(m == "mamba" for m in self.mixer_pattern())

    @property
    def is_subquadratic(self) -> bool:
        """True iff every decoder mixer has O(1)-per-token decode state
        (SSM state or bounded SWA window) — gate for the long_500k shape."""
        for i in range(self.num_layers):
            if self.mixer_kind(i) == "attn":
                if not (self.sliding_window > 0 and self.layer_is_swa(i)):
                    # full-attention layer: unbounded KV — still OK for hybrid
                    # archs where such layers are a small minority (Jamba), as
                    # batch=1 keeps the cache in device memory; pure
                    # full-attention archs skip.
                    if self.ssm is None:
                        return False
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- accounting
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d                       # token embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        n += d                                        # final norm

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            b = (self.num_heads * hd + 2 * self.num_kv_heads * hd) if self.qkv_bias else 0
            return q + kv + o + b

        def mamba_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_ch = di + 2 * s.n_groups * s.d_state
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            return in_proj + conv_ch * s.conv_width + conv_ch + nh * 2 + nh + di * d + di

        def dense_ffn() -> int:
            return 3 * d * self.d_ff                  # SwiGLU: gate, up, down

        def moe_ffn() -> int:
            m = self.moe
            de = m.d_expert or self.d_ff
            router = d * m.num_experts
            experts = m.num_experts * 3 * d * de
            shared = m.num_shared_experts * 3 * d * de
            return router + experts + shared

        def block(layer: int, cross: bool = False) -> int:
            p = d  # pre-mixer norm
            mk = self.mixer_kind(layer)
            p += attn_params() if mk == "attn" else mamba_params()
            if cross:
                p += d + attn_params()                # cross-attn + its norm
            fk = self.ffn_kind(layer)
            if fk != "none":
                p += d                                # pre-ffn norm
                p += dense_ffn() if fk == "dense" else moe_ffn()
            return p

        n += sum(block(i, cross=self.is_encdec) for i in range(self.num_layers))
        if self.is_encdec:
            # encoder blocks: self-attn + dense FFN
            enc_block = d + attn_params() + d + dense_ffn()
            n += self.encoder_layers * enc_block + d  # + encoder final norm
        if self.frontend is not None:
            n += self.frontend.embed_dim * d + d      # projector
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        de = m.d_expert or self.d_ff
        per_expert = 3 * self.d_model * de
        inactive = (m.num_experts - m.top_k) * per_expert
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.ffn_kind(i) == "moe")
        return self.param_count() - n_moe_layers * inactive


# ---------------------------------------------------------------------------
# Shapes (the dry-run cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


# ---------------------------------------------------------------------------
# Training / runtime configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"     # 'cosine' | 'linear' | 'constant' | 'wsd'
    moment_dtype: str = "float32"   # bf16 for the 400B MoE
    master_dtype: str = ""       # '' → params kept in param_dtype only
    compress_grads: str = "none"  # 'none' | 'bf16' | 'int8'


@dataclass(frozen=True)
class TrainConfig:
    microbatch_per_device: int = 1
    remat: str = "block"         # 'none' | 'block' | 'full'
    scan_layers: bool = True
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 3
    label_smoothing: float = 0.0
    data_selection: str = "none"  # 'none' | 'greedyml:<fn>' | 'randgreedi:<fn>'
    selection_k: int = 1024


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def is_multi_pod(self) -> bool:
        return "pod" in self.axes


# ---------------------------------------------------------------------------
# Submodular problem configs (the paper's own experiments)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SubmodularConfig:
    """A GreedyML problem instance description."""

    objective: str               # 'kcover' | 'kdom' | 'kmedoid' | 'facility'
    k: int                       # cardinality constraint
    n: int                       # ground-set size
    universe: int = 0            # k-cover/k-dom: universe size (bits)
    feature_dim: int = 0         # k-medoid/facility: feature dim
    num_machines: int = 8        # leaves m of the accumulation tree
    branching: int = 8           # b; L = ceil(log_b m)
    seed: int = 0
    augment: int = 0             # k-medoid: random images added per accum step
