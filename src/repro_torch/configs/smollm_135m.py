"""smollm-135m — llama-architecture small LM.

[hf:HuggingFaceTB/SmolLM-135M] 30L d_model=576 9H (kv=3) d_ff=1536
vocab=49152, tied embeddings. Answers
`src/repro/configs/smollm_135m.py`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1_536,
    vocab_size=49_152,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
