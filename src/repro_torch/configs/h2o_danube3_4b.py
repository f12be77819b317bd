"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L d_model=3840 32H (kv=8) d_ff=10240 vocab=32000.
Every layer uses SWA (window 4096) → sub-quadratic decode: long_500k
RUNS with a bounded ring-buffer KV cache. Answers
`src/repro/configs/h2o_danube3_4b.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10_240,
    vocab_size=32_000,
    sliding_window=4_096,
    swa_pattern=1,               # SWA on every layer
    rope_theta=500_000.0,
)
