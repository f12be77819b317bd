"""jamba-v0.1-52b — hybrid Mamba + attention (1:7 interleave) with MoE.

[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1] 32L d_model=4096 32H (kv=8)
d_ff=14336 vocab=65536, MoE 16e top-2 every other layer; attention at
layer index 4 within each 8-layer Jamba block, Mamba elsewhere. NOTE (an
adaptation of the reference): Jamba v0.1 uses Mamba-1 (d_state=16); this
framework implements the Mamba-2 SSD mixer (matmul-friendly) with the
same state size — recorded as an intentional deviation. Answers
`src/repro/configs/jamba_v01_52b.py`.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    attn_every=8,
    attn_offset=4,               # 1 attention layer per 8 (1:7 attn:mamba)
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14_336),
    moe_every=2,
    moe_offset=1,                # MoE on odd layers, dense on even
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
)
