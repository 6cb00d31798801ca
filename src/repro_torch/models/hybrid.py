"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block.

Counterpart of ``repro/models/hybrid.py``.  ``cfg.n_layers`` Mamba2 blocks;
after every ``cfg.hybrid_period`` of them the single shared transformer
block (the transformer's attention + MLP block, one parameter set) is
applied, then the remainder blocks.  Each of the ``n_layers //
hybrid_period`` invocations keeps its own contiguous KV cache.

Residual taps follow the reference: Mamba block ``i`` at ``i``, shared
invocation ``g`` at ``10_000 + g``.  In training every block — each Mamba
block and each shared invocation — runs under ``cfg.remat`` on its own;
the reference's outer checkpoint around each group changes memory, not
values.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixed_point import QuantStats
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.dist.sharding import is_placed
from repro_torch.models.common import (ParamDef, embed_defs, embed_lookup,
                                       fused_unembed_xent, last_logits,
                                       last_position, merge_optional,
                                       placed_cache, placed_lm_loss,
                                       placed_pos, rms_norm, row_positions,
                                       unembed, zeros_from)
from repro_torch.models.mlp import count_mlp_params
from repro_torch.models.transformer import (_layer, remat_call, stack_defs,
                                            unbind_layers, write_caches)

# the shared block's tap index is this plus its invocation
SHARED_TAP_BASE = 10_000


def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_period


def _split(cfg: ModelConfig):
    """(n_groups, group_size, remainder) of the mamba stack."""
    g = n_shared_invocations(cfg)
    k = cfg.hybrid_period
    return g, k, cfg.n_layers - g * k


def model_defs(cfg: ModelConfig, dtype: torch.dtype = None) -> Dict[str, Any]:
    dt = dtype or cfg.activation_dtype()
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model, tie=cfg.tie_embed, dtype=dt),
        "mamba": stack_defs(cfg.n_layers, mamba.layer_defs(cfg, dt)),
        "shared": transformer.layer_defs(cfg, dt),   # ONE shared block
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int):
    """Stand-ins (``meta`` device) of the decode cache: ``{"ssm": (state
    (L, B, H, P, N), tail (L, B, K-1, C)) fp32, "attn": (k, v) each (G, B,
    max_seq, KV, Dh)}`` — int8 under ``kv_cache_bits`` 8, else the compute
    dtype."""
    G = n_shared_invocations(cfg)
    dt = torch.int8 if cfg.kv_cache_bits == 8 else cfg.activation_dtype()
    kv = (G, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"ssm": mamba.cache_struct(cfg, batch, max_seq),
            "attn": tuple(torch.empty(kv, dtype=dt, device="meta")
                          for _ in range(2))}


def cache_logical(cfg: ModelConfig):
    sp = ("layers", "batch", "kv_seq", "kv", "head_dim")
    return {"ssm": mamba.cache_logical(cfg), "attn": (sp, sp)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """The zeroed decode cache of :func:`cache_struct`."""
    return zeros_from(cache_struct(cfg, batch, max_seq), device)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            mode: str = "prefill", cache=None, cache_pos=None,
            hidden_only: bool = False):
    """Returns (logits | hidden, new_cache).  Decode writes ``cache`` in
    place and hands it back; prefill returns the caches of the prompt."""
    x = embed_lookup(params["embed"]["tok"], tokens).to(cfg.activation_dtype())
    S = x.shape[1]
    G, K, _ = _split(cfg)
    placed = is_placed(x)
    if mode == "decode":
        positions = row_positions(cache_pos)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    layers = params["mamba"]
    ssm_cache = None if cache is None else cache["ssm"]
    attn_cache = None if cache is None else cache["attn"]
    if placed:
        # the per-layer (and per-invocation) slices, once per distinct block
        layers = unbind_layers(layers, cfg.n_layers)
        ssm_cache = unbind_layers(ssm_cache, cfg.n_layers)
        attn_cache = unbind_layers(attn_cache, G)

    ssm_new, attn_new = [], []
    for g in range(G):
        x, new = mamba.run_layers(cfg, layers, x, range(g * K, (g + 1) * K),
                                  mode=mode, cache=ssm_cache)
        ssm_new += new
        c = (None if attn_cache is None else attn_cache[g] if placed
             else _layer(attn_cache, g))
        x, kv, _ = transformer._block(
            cfg, params["shared"], x, positions=positions, mode=mode,
            cache=c, cache_pos=cache_pos)
        if placed and mode == "prefill":
            write_caches(c, kv)
        attn_new.append(kv)
    x, new = mamba.run_layers(cfg, layers, x, range(G * K, cfg.n_layers),
                              mode=mode, cache=ssm_cache)
    ssm_new += new

    if mode == "decode" or placed:
        new_cache = cache
    else:
        new_cache = {"ssm": mamba.stack_caches(ssm_new),
                     "attn": tuple(torch.stack(c) for c in zip(*attn_new))}
    x = rms_norm(x, params["final_norm"])
    if hidden_only:
        return x, new_cache
    if mode == "prefill":
        x = last_position(x) if placed else x[:, -1:]
    return unembed(x, params["embed"], cfg.vocab), new_cache


def forward_train(cfg: ModelConfig, params, tokens: torch.Tensor, qctx=None):
    """Training forward: ``(final-normed hidden (B, S, D), act_stats)``."""
    x = embed_lookup(params["embed"]["tok"], tokens).to(cfg.activation_dtype())
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    G, K, _ = _split(cfg)
    layers = unbind_layers(params["mamba"], cfg.n_layers)
    stats = None

    def run(idxs):
        nonlocal x, stats
        for i in idxs:
            x, s = remat_call(cfg, mamba.train_block, cfg, layers[i], x, qctx,
                              i)
            stats = merge_optional(stats, s)

    for g in range(G):
        run(range(g * K, (g + 1) * K))
        x, s, _ = remat_call(cfg, transformer._train_block, cfg,
                             params["shared"], x, positions, qctx,
                             SHARED_TAP_BASE + g)
        stats = merge_optional(stats, s)
    run(range(G * K, cfg.n_layers))
    x = rms_norm(x, params["final_norm"])
    return x, stats or QuantStats.zero(device=x.device)


def loss_fn(cfg: ModelConfig):
    """(params, batch, qctx) -> (loss, aux) for qtrain.make_train_step."""

    def fn(params, batch, qctx=None):
        tokens = batch["tokens"]
        hidden, stats = forward_train(cfg, params, tokens[:, :-1], qctx)
        loss = fused_unembed_xent(hidden, params["embed"], cfg.vocab,
                                  tokens[:, 1:], batch.get("loss_mask"))
        return loss, {"act_stats": stats}

    return fn


def placed_loss_fn(cfg: ModelConfig):
    """:func:`loss_fn` for a placed state: :func:`forward_train` block for
    block, the one placed ``shared`` block in every invocation (its
    gradient the sum over them)."""
    return placed_lm_loss(cfg, forward_train)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int):
    """Run the prompt; return (last_logits, cache with the attention caches
    padded to ``max_seq``, pos).  On a placed state and placed tokens the
    cache is placed by :func:`cache_logical` at ``max_seq`` and written
    layer by layer and invocation by invocation."""
    if is_placed(tokens):
        cache = placed_cache(cache_struct(cfg, tokens.shape[0], max_seq),
                             cache_logical(cfg), tokens)
        logits, _ = forward(cfg, params, tokens, mode="prefill", cache=cache)
        return last_logits(logits), cache, placed_pos(tokens, tokens.shape[1])
    logits, cache = forward(cfg, params, tokens, mode="prefill")
    S = tokens.shape[1]
    cache["attn"] = tuple(torch.nn.functional.pad(
        c, (0, 0, 0, 0, 0, max_seq - S)) for c in cache["attn"])
    pos = torch.full((tokens.shape[0],), S, dtype=torch.int32,
                     device=tokens.device)
    return logits[:, -1], cache, pos


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos):
    """One token per row.  Returns (logits (B, vocab), cache) — the cache is
    written in place."""
    logits, _ = forward(cfg, params, tokens, mode="decode", cache=cache,
                        cache_pos=pos)
    return last_logits(logits), cache


def count_params(cfg: ModelConfig) -> float:
    mamba_n = cfg.n_layers * (cfg.d_model + ssm_lib.count_ssm_params(cfg))
    shared = (2 * cfg.d_model + attn_lib.count_gqa_params(cfg)
              + count_mlp_params(cfg.d_model, cfg.d_ff, cfg.gated_mlp))
    total = mamba_n + shared + cfg.d_model
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embed else 2)
    return float(total)


def residual_taps(cfg: ModelConfig) -> int:
    """Residual taps a training forward makes: one a Mamba2 block and one
    an invocation of the shared block."""
    return cfg.n_layers + n_shared_invocations(cfg)
