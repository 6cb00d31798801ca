"""Config schema: model architecture + numerics.

Counterpart of ``repro/configs/base.py``.  Every ported architecture is one
``ModelConfig`` in its own module under ``repro_torch.configs``;
``get_config(name)`` is the registry entry point and ``smoke()`` derives the
reduced-size variant used by the CPU tests.  The schema keeps every field of
the reference (so a config reads the same in both packages) although only
the dense family is ported.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated_mlp: bool = True
    attn_bias: bool = False
    rope_theta: float = 10000.0
    tie_embed: bool = True
    norm: str = "rms"              # rms | layer
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    hybrid_period: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0
    # --- VLM (internvl2) ---
    n_patches: int = 0
    # --- numerics / training ---
    dtype: str = "bfloat16"        # compute dtype for LM-scale runs
    param_dtype: str = "float32"
    remat: str = "full"
    train_accum: int = 1
    kv_cache_bits: int = 16        # 16 = cache in the compute dtype; 8 = int8
    probe_unroll: bool = False
    attn_batch2d: bool = False
    moe_a2a_bits: int = 16
    # --- shape applicability ---
    supports_long: bool = False

    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def master_dtype(self) -> torch.dtype:
        """dtype of the parameters a trainer keeps (``param_dtype``)."""
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32

    def n_params(self) -> float:
        """Analytic parameter count."""
        from repro_torch.models import registry
        return registry(self.family).count_params(self)


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        q_lora_rank=16 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_dim=16 if cfg.qk_nope_dim else 0,
        qk_rope_dim=8 if cfg.qk_rope_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_head_dim else 0,
        ssm_chunk=8,
        hybrid_period=2 if cfg.hybrid_period else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=16 if cfg.enc_seq else 0,
        n_patches=4 if cfg.n_patches else 0,
        dtype="float32",
        remat="none",
        train_accum=1,
    )
