"""qwen3-moe-30b-a3b — fine-grained MoE: 128 experts, top-8.

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (kv=4, head_dim=128) expert
d_ff=768 vocab=151936 → ~3B active / ~30B total. Answers
`src/repro/configs/qwen3_moe_30b.py`.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                      # all layers MoE
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
    moe_every=1,
)
