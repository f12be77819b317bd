"""llava-next-mistral-7b — VLM: mistral-7b backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L d_model=4096 32H (kv=8)
d_ff=14336 vocab=32000. Anyres tiling: base image + 2×2 grid of tiles →
5 × 576 = 2880 CLIP-L patch embeddings (1024-dim), provided PRECOMPUTED
by ``input_specs()`` (the vision tower is a stub); a linear projector
scatters them into the first 2880 sequence positions. Answers
`src/repro/configs/llava_next_mistral_7b.py`.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", num_embeds=2_880, embed_dim=1024),
)
