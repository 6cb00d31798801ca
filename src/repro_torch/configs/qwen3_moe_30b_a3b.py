"""qwen3-moe-30b-a3b [moe] — 48L d=2048 32H (GQA kv=4) V=151936,
128 experts top-8, expert ff=768. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936, act="silu", gated_mlp=True,
    rope_theta=1000000.0, tie_embed=True,
    n_experts=128, top_k=8, moe_d_ff=768, capacity_factor=1.25,
)
