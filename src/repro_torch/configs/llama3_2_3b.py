"""llama3.2-3b [dense] — 28L d=3072 24H (GQA kv=8) ff=8192 V=128256.
[hf:meta-llama/Llama-3.2-3B; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, act="silu", gated_mlp=True,
    rope_theta=500000.0, tie_embed=True,
)
