"""Model configurations, one module per architecture, each found by its
module name (``base.get_config``): llama3_2_3b, gemma_7b,
mistral_large_123b, nemotron_4_340b (dense), qwen3_moe_30b_a3b,
deepseek_v2_236b (MoE, the latter with MLA), internvl2_26b (VLM),
mamba2_1_3b (SSM), zamba2_7b (hybrid) and whisper_medium (encdec)."""
