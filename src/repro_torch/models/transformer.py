"""Decoder-only transformer LM, dense variant (llama3.2 and kin).

Counterpart of ``repro/models/transformer.py``.  Parameters are a nested
dict of tensors with the reference's keys; per-layer weights are stacked on
a leading ``L`` dim and the layer stack is a Python loop over it (the
reference scans).  Caches are stacked over layers the same way and updated
in place.

Training (:func:`forward_train`, :func:`loss_fn`): the parameters are the
trainer's master copy (``cfg.param_dtype``, fp32) and are cast to the
compute dtype inside each block; the residual stream is tapped after every
block (quantize + stats, :meth:`repro_torch.core.qtrain.QCtx.tap`); with
``remat="full"`` each block runs under ``torch.utils.checkpoint``, its
statistics returned from the block rather than recorded beside it.

Not ported yet: MoE and MLA layers, vision embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import QuantStats
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (ParamDef, embed_defs, embed_lookup,
                                       fused_unembed_xent, layer_norm,
                                       map_defs, rms_norm, unembed)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA layers are not ported yet (dense only)")


def stack_defs(n: int, defs):
    """Prepend a stacked ``layers`` dim to every ParamDef in a tree."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, init=d.init,
                                       scale=d.scale, dtype=d.dtype), defs)


def layer_defs(cfg: ModelConfig, dt: torch.dtype) -> Dict[str, Any]:
    _check_dense(cfg)
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


def model_defs(cfg: ModelConfig, dtype: torch.dtype = None) -> Dict[str, Any]:
    """Parameter declarations.  The weight matrices take ``dtype``: the
    compute dtype by default (serving), ``cfg.master_dtype()`` for a
    trainer's master copy.  Norm scales are fp32 either way."""
    dt = dtype or cfg.activation_dtype()
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model, tie=cfg.tie_embed, dtype=dt),
        "layers": stack_defs(cfg.n_layers, layer_defs(cfg, dt)),
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


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def unbind_layers(layers, n: int):
    """The stacked layer tree as ``n`` per-layer trees, each stacked leaf
    split by ONE ``torch.unbind``.  Indexing ``leaf[i]`` once per layer
    would give every layer its own select node, whose backward writes a
    full stacked-size zero gradient and adds it into the leaf's (28 × the
    leaf's bytes of memset-and-add per step at llama3.2-3b); an unbind's
    backward stacks the ``n`` slice gradients once."""
    split = tree_lib.map_tree(lambda t: torch.unbind(t, 0), layers)
    return [tree_lib.map_tree(lambda parts: parts[i], split) for i in range(n)]


def _train_block(cfg: ModelConfig, p, x, positions, qctx, idx: int):
    """One block in train mode on the compute dtype, then the residual tap.
    Returns (x, QuantStats) — the stats as values, so a checkpointed block
    hands them out once however often it is recomputed."""
    dt = cfg.activation_dtype()
    p = tree_lib.map_tree(lambda w: w.to(dt) if w.ndim >= 2 else w, p)
    x, _ = _block(cfg, p, x, positions=positions, mode="train", cache=None,
                  cache_pos=None)
    if qctx is None:
        return x, None
    return qctx.tap(x, idx)


def forward_train(cfg: ModelConfig, params, tokens: torch.Tensor, qctx=None):
    """Training forward: ``(final-normed hidden (B, S, D), act_stats)``."""
    from torch.utils.checkpoint import checkpoint
    _check_dense(cfg)
    if cfg.remat not in ("full", "none"):
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported "
                                  "(full or none)")
    x = embed_lookup(params["embed"]["tok"], tokens).to(cfg.activation_dtype())
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    stats = None
    for i, p in enumerate(unbind_layers(params["layers"], cfg.n_layers)):
        if cfg.remat == "full":
            x, s = checkpoint(_train_block, cfg, p, x, positions, qctx, i,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, s = _train_block(cfg, p, x, positions, qctx, i)
        if s is not None:
            stats = s if stats is None else stats.merge(s)
    x = _norm(cfg, x, params["final_norm"])
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
