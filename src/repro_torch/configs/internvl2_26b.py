"""internvl2-26b [vlm] — internlm2-20b backbone: 48L d=6144 48H (GQA kv=8)
ff=16384 V=92553; InternViT frontend STUBBED (patch embeddings arrive
precomputed, 256 vision tokens). [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, act="silu", gated_mlp=True,
    rope_theta=1000000.0, tie_embed=False,
    n_patches=256,
    train_accum=2,
)
