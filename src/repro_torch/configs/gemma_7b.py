"""gemma-7b [dense] — 28L d=3072 16H (MHA kv=16) ff=24576 V=256000.
GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="gelu", gated_mlp=True,
    rope_theta=10000.0, tie_embed=True,
    train_accum=2,
)
