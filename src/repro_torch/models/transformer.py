"""Decoder-only transformer LM, dense variant (llama3.2 and kin).

Counterpart of ``repro/models/transformer.py``.  Parameters are a nested
dict of tensors with the reference's keys; per-layer weights are stacked on
a leading ``L`` dim and the layer stack is a Python loop over it (the
reference scans).  Caches are stacked over layers the same way and updated
in place.

Not ported yet: MoE and MLA layers, vision embeddings, the training loss and
the activation taps of the quantized training step.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (ParamDef, embed_defs, embed_lookup,
                                       layer_norm, map_defs, rms_norm, unembed)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA layers are not ported yet (dense only)")


def stack_defs(n: int, defs):
    """Prepend a stacked ``layers`` dim to every ParamDef in a tree."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, init=d.init,
                                       scale=d.scale, dtype=d.dtype), defs)


def layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_dense(cfg)
    dt = cfg.activation_dtype()
    defs: Dict[str, Any] = {
        "norm1": ParamDef((cfg.d_model,), init="ones"),
        "norm2": ParamDef((cfg.d_model,), init="ones"),
    }
    if cfg.norm == "layer":
        defs["norm1_b"] = ParamDef((cfg.d_model,), init="zeros")
        defs["norm2_b"] = ParamDef((cfg.d_model,), init="zeros")
    defs["attn"] = attn_lib.gqa_defs(cfg, dt)
    defs["mlp"] = mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt)
    return defs


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    dt = cfg.activation_dtype()
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model, tie=cfg.tie_embed, dtype=dt),
        "layers": stack_defs(cfg.n_layers, layer_defs(cfg)),
        "final_norm": ParamDef((cfg.d_model,), init="ones"),
    }


def _norm(cfg, x, scale, bias=None):
    if cfg.norm == "layer":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def _block(cfg: ModelConfig, p, x, *, positions, mode, cache, cache_pos,
           paged_ptab=None, paged_backend="auto"):
    """One transformer block.  Returns (x, new_cache)."""
    h = _norm(cfg, x, p["norm1"], p.get("norm1_b"))
    a_out, new_cache = attn_lib.gqa_apply(
        cfg, p["attn"], h, positions=positions, mode=mode, cache=cache,
        cache_pos=cache_pos, paged_ptab=paged_ptab,
        paged_backend=paged_backend)
    x = x + a_out
    h = _norm(cfg, x, p["norm2"], p.get("norm2_b"))
    x = x + mlp_lib.mlp_apply(cfg, p["mlp"], h)
    return x, new_cache


def _layer(tree, i: int):
    """Layer ``i`` of a tree of tensors stacked on a leading L dim (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def _run_stack(cfg: ModelConfig, layers, x, *, positions, mode, cache=None,
               cache_pos=None, paged_ptab=None, paged_backend="auto"):
    """The layer loop.  Returns (x, new_cache stacked over layers).

    In decode the per-layer cache slices are views that the block writes in
    place, so the stacked cache handed in is the one handed back."""
    per_layer = []
    for i in range(cfg.n_layers):
        x, new_cache = _block(
            cfg, _layer(layers, i), x, positions=positions, mode=mode,
            cache=None if cache is None else _layer(cache, i),
            cache_pos=cache_pos, paged_ptab=paged_ptab,
            paged_backend=paged_backend)
        per_layer.append(new_cache)
    if mode == "decode":
        return x, cache
    return x, tuple(torch.stack(c) for c in zip(*per_layer))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            mode: str = "prefill", cache=None, cache_pos=None,
            hidden_only: bool = False, paged_ptab=None,
            paged_backend: str = "auto"):
    """Returns (logits | hidden, new_cache).

    ``mode="prefill"`` unembeds the LAST position only (the serving loop
    needs just the next-token logits).  ``hidden_only=True`` skips
    unembedding."""
    _check_dense(cfg)
    x = embed_lookup(params["embed"]["tok"], tokens).to(cfg.activation_dtype())
    S = x.shape[1]
    if mode == "decode":
        positions = cache_pos[:, None]                      # (B, 1)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]

    x, new_cache = _run_stack(
        cfg, params["layers"], x, positions=positions, mode=mode, cache=cache,
        cache_pos=cache_pos, paged_ptab=paged_ptab, paged_backend=paged_backend)

    x = _norm(cfg, x, params["final_norm"])
    if hidden_only:
        return x, new_cache
    if mode == "prefill":
        x = x[:, -1:]
    return unembed(x, params["embed"], cfg.vocab), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zeroed contiguous decode cache, stacked over layers."""
    dt = torch.int8 if cfg.kv_cache_bits == 8 else cfg.activation_dtype()
    shp = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shp, dtype=dt, device=device),
            torch.zeros(shp, dtype=dt, device=device))


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int):
    """Run the prompt, return (last_logits, cache padded to max_seq, pos)."""
    logits, cache = forward(cfg, params, tokens, mode="prefill")
    S = cache[0].shape[2]
    pad = (0, 0, 0, 0, 0, max_seq - S)      # (Dh, KV, seq) from the last dim
    cache = tuple(torch.nn.functional.pad(c, pad) for c in cache)
    pos = torch.full((tokens.shape[0],), S, dtype=torch.int32,
                     device=tokens.device)
    return logits[:, -1], cache, pos


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos):
    """One token per row.  tokens (B, 1); pos (B,) write positions.

    Returns (logits (B, vocab), cache) — the cache is written in place."""
    logits, new_cache = forward(cfg, params, tokens, mode="decode",
                                cache=cache, cache_pos=pos)
    return logits[:, -1], new_cache


def decode_step_paged(cfg: ModelConfig, params, tokens: torch.Tensor, cache,
                      ptab: torch.Tensor, pos: torch.Tensor, *,
                      backend: str = "auto"):
    """One token per row against the paged KV pool (repro_torch.serve).

    ``cache``: the serve layer's ``(k_pages, v_pages, k_fmt, v_fmt)`` stacked
    over layers (leading dim L).  ``ptab`` (B, P) int32 logical→physical
    page table shared by every layer; ``pos`` (B,) absolute write positions.
    Returns (logits (B, vocab), cache) — the pools are written in place."""
    logits, new_cache = forward(cfg, params, tokens, mode="decode",
                                cache=cache, cache_pos=pos, paged_ptab=ptab,
                                paged_backend=backend)
    return logits[:, -1], new_cache


def count_params(cfg: ModelConfig) -> float:
    _check_dense(cfg)
    per_layer = 2 * cfg.d_model
    per_layer += attn_lib.count_gqa_params(cfg)
    per_layer += mlp_lib.count_mlp_params(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    total = cfg.n_layers * per_layer + cfg.d_model
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embed else 2)
    return float(total)
