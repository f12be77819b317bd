"""llama4-maverick-400b-a17b — MoE with 128 routed experts (top-1) + 1 shared.

[hf:meta-llama/Llama-4-Maverick-17B-128E] 48L d_model=5120 40H (kv=8)
d_ff=8192 (expert hidden) vocab=202048, MoE 128e top-1 + shared expert →
~17B active / ~780B total. Optimizer moments kept in bf16. Answers
`src/repro/configs/llama4_maverick.py`.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                      # all layers MoE
    vocab_size=202_048,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=128, top_k=1, d_expert=8_192,
                  num_shared_experts=1),
    moe_every=1,
)
