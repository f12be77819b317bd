"""mamba2-1.3b — attention-free SSM LM (state-space duality / SSD).

[arXiv:2405.21060] 48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128.
Pure Mamba-2 blocks: no attention, no FFN (the SSD mixer IS the block).
Answers `src/repro/configs/mamba2_1p3b.py`.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=0,                      # no FFN: SSD mixer only (official mamba2 LM)
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
)
