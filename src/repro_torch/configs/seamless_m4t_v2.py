"""seamless-m4t-large-v2 — encoder–decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large] 24L enc + 24L dec,
d_model=1024 16H (kv=16 = MHA) d_ff=8192 vocab=256206. The speech
frontend (w2v-BERT conformer feature extractor) is a stub:
``input_specs()`` supplies precomputed 1024-dim frame embeddings.
Answers `src/repro/configs/seamless_m4t_v2.py`.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,               # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8_192,
    vocab_size=256_206,
    frontend=FrontendConfig(kind="audio", num_embeds=0, embed_dim=1024),
)
