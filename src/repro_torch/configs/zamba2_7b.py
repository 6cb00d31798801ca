"""zamba2-7b [hybrid] — 81 Mamba2 blocks d=3584, shared attn block (32H
MHA, ff=14336) every 6 blocks, ssm_state=64, V=32000.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, act="silu", gated_mlp=True,
    rope_theta=10000.0, tie_embed=True,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    hybrid_period=6, supports_long=True,
    train_accum=2,
)
