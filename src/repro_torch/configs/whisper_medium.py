"""whisper-medium [audio] — enc-dec 24L+24L d=1024 16H (MHA) ff=4096
V=51865; conv frontend STUBBED (frame embeddings arrive precomputed,
enc_seq=1500). LayerNorm, GELU, biases, sinusoidal positions.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, act="gelu", gated_mlp=False, attn_bias=True,
    norm="layer", rope_theta=0.0, tie_embed=True,
    n_enc_layers=24, enc_seq=1500,
)
