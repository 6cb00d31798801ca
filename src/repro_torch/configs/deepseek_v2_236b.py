"""deepseek-v2-236b [moe] — 60L d=5120 128H MLA (kv_lora=512, rope=64),
2 shared + 160 routed experts top-6, expert ff=1536, V=102400.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=0, vocab=102400, act="silu", gated_mlp=True,
    rope_theta=10000.0, tie_embed=False,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    capacity_factor=1.25,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    train_accum=4,
)
