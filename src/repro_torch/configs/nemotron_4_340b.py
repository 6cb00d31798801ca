"""nemotron-4-340b [dense] — 96L d=18432 96H (GQA kv=8) ff=73728 V=256000.
Squared-ReLU, non-gated MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, act="relu2", gated_mlp=False,
    rope_theta=10000.0, tie_embed=False,
    train_accum=8,
)
