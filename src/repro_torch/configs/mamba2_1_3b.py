"""mamba2-1.3b [ssm] — 48L d=2048 attn-free, SSD state=128, V=50280.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, act="silu",
    rope_theta=0.0, tie_embed=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    supports_long=True,
    train_accum=2,
)
