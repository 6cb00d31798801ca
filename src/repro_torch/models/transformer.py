"""Decoder-only transformer LM: dense (llama3.2 and kin), MoE (qwen3-moe,
deepseek-v2 — the latter with MLA) and VLM-backbone (internvl2: patch
embeddings from the stubbed vision frontend are prepended to the token
sequence) variants.

Counterpart of ``repro/models/transformer.py``.  Parameters are a nested
dict of tensors with the reference's keys; per-layer weights are stacked on
a leading ``L`` dim and the layer stack is a Python loop over it (the
reference scans).  Caches are stacked over layers the same way and updated
in place.

Training (:func:`forward_train`, :func:`loss_fn`): the parameters are the
trainer's master copy (``cfg.param_dtype``, fp32) and are cast to the
compute dtype inside each block; the residual stream is tapped after every
block (quantize + stats, :meth:`repro_torch.core.qtrain.QCtx.tap`); with
``remat="full"`` each block runs under ``torch.utils.checkpoint``, and with
``remat="dots"`` under it with a selective policy that keeps the matrix
products' outputs and recomputes the rest.  Either way the block's
statistics and MoE auxiliary loss leave it as values rather than being
recorded beside it.

An MLA model's decode cache is its two latent caches, (L, B, S,
kv_lora_rank) and (L, B, S, qk_rope_dim), in place of the GQA model's K
and V.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixed_point import QuantStats
from repro_torch.dist.sharding import (is_placed, logical_constraint,
                                       relayout, unbind_placed, write_prefix)
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (ParamDef, compute_cast, embed_defs,
                                       embed_lookup, fused_unembed_xent,
                                       fused_unembed_xent_placed,
                                       last_logits, last_position, layer_norm,
                                       map_defs, merge_optional, placed_cache,
                                       placed_pos, rms_norm, row_positions,
                                       unembed, whole_but_batch, zeros_from)


def stack_defs(n: int, defs):
    """Prepend a stacked ``layers`` dim to every ParamDef in a tree."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.logical,
                                       init=d.init, scale=d.scale,
                                       dtype=d.dtype), defs)


def layer_defs(cfg: ModelConfig, dt: torch.dtype) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "norm1": ParamDef((cfg.d_model,), (None,), init="ones"),
        "norm2": ParamDef((cfg.d_model,), (None,), init="ones"),
    }
    if cfg.norm == "layer":
        defs["norm1_b"] = ParamDef((cfg.d_model,), (None,), init="zeros")
        defs["norm2_b"] = ParamDef((cfg.d_model,), (None,), init="zeros")
    defs["attn"] = (attn_lib.mla_defs(cfg, dt) if cfg.mla
                    else attn_lib.gqa_defs(cfg, dt))
    if cfg.n_experts:
        defs["moe"] = moe_lib.moe_defs(cfg, dt)
    else:
        defs["mlp"] = mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt)
    return defs


def model_defs(cfg: ModelConfig, dtype: torch.dtype = None) -> Dict[str, Any]:
    """Parameter declarations.  The weight matrices take ``dtype``: the
    compute dtype by default (serving), ``cfg.master_dtype()`` for a
    trainer's master copy.  Norm scales and the MoE router are fp32 either
    way."""
    dt = dtype or cfg.activation_dtype()
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model, tie=cfg.tie_embed, dtype=dt),
        "layers": stack_defs(cfg.n_layers, layer_defs(cfg, dt)),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def _norm(cfg, x, scale, bias=None):
    if cfg.norm == "layer":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def _block(cfg: ModelConfig, p, x, *, positions, mode, cache, cache_pos,
           paged_ptab=None, paged_backend="auto"):
    """One transformer block.  Returns (x, new_cache, aux_loss): the MoE
    layer's load-balance loss, ``None`` for a dense one.  On placed
    activations (the placed train step, placed prefill and decode) each
    layer runs its placed form and the results are placed."""
    h = _norm(cfg, x, p["norm1"], p.get("norm1_b"))
    if cfg.mla:
        a_out, new_cache = attn_lib.mla_apply(
            cfg, p["attn"], h, positions=positions, mode=mode, cache=cache,
            cache_pos=cache_pos)
    else:
        a_out, new_cache = attn_lib.gqa_apply(
            cfg, p["attn"], h, positions=positions, mode=mode, cache=cache,
            cache_pos=cache_pos, paged_ptab=paged_ptab,
            paged_backend=paged_backend)
    x = x + a_out
    h = _norm(cfg, x, p["norm2"], p.get("norm2_b"))
    aux_loss = None
    if cfg.n_experts:
        m_out, aux_loss = moe_lib.moe_apply(cfg, p["moe"], h)
    else:
        m_out = mlp_lib.mlp_apply(cfg, p["mlp"], h)
    return x + m_out, new_cache, aux_loss


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
    place, so the stacked cache handed in is the one handed back.  On
    placed activations the layers and the cache (placed, allocated at
    ``max_seq`` by :func:`prefill`) are unbound once per distinct block;
    prefill writes each layer's keys and values into its slice."""
    placed = is_placed(x)
    if placed:
        layers = unbind_layers(layers, cfg.n_layers)
        caches = unbind_layers(cache, cfg.n_layers)
    per_layer = []
    for i in range(cfg.n_layers):
        if placed:
            p, c = layers[i], caches[i]
        else:
            p, c = _layer(layers, i), None if cache is None else _layer(
                cache, i)
        x, new_cache, _ = _block(
            cfg, p, x, positions=positions, mode=mode, cache=c,
            cache_pos=cache_pos, paged_ptab=paged_ptab,
            paged_backend=paged_backend)
        if placed and mode == "prefill":
            write_caches(c, new_cache)
        per_layer.append(new_cache)
    if mode == "decode" or placed:
        return x, cache
    return x, tuple(torch.stack(c) for c in zip(*per_layer))


def write_caches(dst, new) -> None:
    """Prefill on placed activations: each placed cache of a layer's slice
    ``dst`` (a tuple) written from the prompt's ``new`` (its first
    positions), each rank its block."""
    for d, n in zip(dst, new):
        write_prefix(d, n)


def _embed(cfg: ModelConfig, params, tokens, vision_embeds):
    """Token embeddings in the compute dtype, the vision prefix (B, P, D)
    prepended when given.  With a prefix the tokens' embeddings keep their
    whole sequence until the concatenation, and the (B, P + T, D) result
    takes the sequence split: placed, each rank's block is the one the
    reference's layout gives it."""
    x = embed_lookup(params["embed"]["tok"], tokens,
                     "tp_seq" if vision_embeds is None else None
                     ).to(cfg.activation_dtype())
    if vision_embeds is not None:
        cat = lambda t, v: torch.cat([v.to(t.dtype), t], dim=1)
        x = (x.map(cat, relayout(vision_embeds, x.spec)) if is_placed(x)
             else cat(x, vision_embeds))
        x = logical_constraint(x, "batch", "tp_seq", "embed")
    return x


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None,
            mode: str = "prefill", cache=None, cache_pos=None,
            hidden_only: bool = False, paged_ptab=None,
            paged_backend: str = "auto"):
    """Returns (logits | hidden, new_cache).

    ``vision_embeds`` (B, n_patches, D) are prepended to the token
    embeddings, and positions run over the whole sequence.
    ``mode="prefill"`` unembeds the LAST position only (the serving loop
    needs just the next-token logits).  ``hidden_only=True`` skips
    unembedding."""
    x = _embed(cfg, params, tokens, vision_embeds)
    S = x.shape[1]
    if mode == "decode":
        positions = row_positions(cache_pos)                # (B, 1)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]

    x, new_cache = _run_stack(
        cfg, params["layers"], x, positions=positions, mode=mode, cache=cache,
        cache_pos=cache_pos, paged_ptab=paged_ptab, paged_backend=paged_backend)

    x = _norm(cfg, x, params["final_norm"])
    if hidden_only:
        return x, new_cache
    if mode == "prefill":
        x = last_position(x) if is_placed(x) else x[:, -1:]
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
    backward stacks the ``n`` slice gradients once.  A placed leaf splits
    each distinct block once (the layers dim is never split)."""
    def split(leaf):
        if not is_placed(leaf):
            return list(torch.unbind(leaf, 0))
        return unbind_placed(leaf, 0)
    split_tree = map_nodes(split, layers)
    return [map_nodes(lambda parts: parts[i], split_tree) for i in range(n)]


def map_nodes(fn, tree):
    """``fn`` at every leaf of a tree of dicts and tuples (a parameter
    tree, a decode cache)."""
    if isinstance(tree, dict):
        return {k: map_nodes(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_nodes(fn, v) for v in tree)
    return fn(tree)


def _train_block(cfg: ModelConfig, p, x, positions, qctx, idx: int):
    """One block in train mode on the compute dtype, then the residual tap.
    Returns (x, QuantStats, aux_loss) — the stats and the MoE loss as
    values, so a checkpointed block hands them out once however often it
    is recomputed."""
    p = compute_cast(cfg, p, layer_defs)
    x, _, aux = _block(cfg, p, x, positions=positions, mode="train",
                       cache=None, cache_pos=None)
    if qctx is None:
        return x, None, aux
    x, stats = qctx.tap(x, idx)
    return x, stats, aux


# the matrix products whose outputs remat="dots" keeps (what ``@``,
# ``torch.einsum`` and ``torch.matmul`` reach at dispatch), as the
# reference's ``checkpoint_dots`` keeps every dot's
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: as it is (``"none"``), under
    ``torch.utils.checkpoint`` (``"full"``), or under it with the policy
    that keeps the matrix products' outputs (``"dots"``).  Every family's
    training forward runs each block through it."""
    if cfg.remat == "none":
        return fn(*args)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be full, dots or none, got "
                         f"{cfg.remat!r}")
    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
          if cfg.remat == "dots" else {})
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def forward_train(cfg: ModelConfig, params, tokens: torch.Tensor, qctx=None,
                  vision_embeds: Optional[torch.Tensor] = None):
    """Training forward: ``(final-normed hidden (B, S, D), act_stats,
    aux_loss)`` — ``aux_loss`` the layers' summed MoE load-balance loss
    (fp32 0 for a dense model).  ``vision_embeds`` as in :func:`forward`.
    On a placed state and placed tokens (:func:`placed_loss_fn`) the
    hidden states and a MoE model's loss come out placed (every rank its
    own copy of the loss)."""
    x = _embed(cfg, params, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    stats, aux_loss = None, None
    for i, p in enumerate(unbind_layers(params["layers"], cfg.n_layers)):
        x, s, aux = remat_call(cfg, _train_block, cfg, p, x, positions, qctx,
                               i)
        stats = merge_optional(stats, s)
        if aux is not None:
            aux_loss = aux if aux_loss is None else aux_loss + aux
    x = _norm(cfg, x, params["final_norm"])
    if aux_loss is None:
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, stats or QuantStats.zero(device=x.device), aux_loss


def loss_fn(cfg: ModelConfig):
    """(params, batch, qctx) -> (loss, aux) for qtrain.make_train_step.

    A batch's ``vision_embeds`` (VLM) are prepended to the tokens, and the
    loss is taken over the token positions only.  The MoE load-balance
    loss, times ``cfg.router_aux_coef``, is added to the loss and reported
    as ``aux["aux_loss"]``."""

    def fn(params, batch, qctx=None):
        tokens = batch["tokens"]
        vision = batch.get("vision_embeds")
        hidden, stats, aux_loss = forward_train(cfg, params, tokens[:, :-1],
                                                qctx, vision)
        if vision is not None:
            hidden = hidden[:, vision.shape[1]:]
        loss = fused_unembed_xent(hidden, params["embed"], cfg.vocab,
                                  tokens[:, 1:], batch.get("loss_mask"))
        aux = {"act_stats": stats}
        if cfg.n_experts:
            loss = loss + cfg.router_aux_coef * aux_loss
            aux["aux_loss"] = aux_loss.detach()
        return loss, aux

    return fn


# ---------------------------------------------------------------------------
# Training on a placed state (launch.specs.build_train_step with a mesh).
# ---------------------------------------------------------------------------

def placed_loss_fn(cfg: ModelConfig):
    """:func:`loss_fn` for a placed state: ``(params, batch, qctx) ->
    (loss, aux)`` with the batch's tensors placed and the loss a placed
    scalar (the global mean on every rank).  The forward is
    :func:`forward_train`'s, block for block; a VLM's prefix positions are
    cut from the gathered hidden states before the loss."""

    def fn(params, batch, qctx=None):
        tokens = batch["tokens"]
        vision = batch.get("vision_embeds")
        hidden, stats, aux_loss = forward_train(
            cfg, params, tokens.map(lambda t: t[:, :-1]), qctx, vision)
        if vision is not None:
            hidden = whole_but_batch(hidden).map(
                lambda t: t[:, vision.shape[1]:])
        loss = fused_unembed_xent_placed(
            hidden, params["embed"], cfg.vocab,
            tokens.map(lambda t: t[:, 1:]), batch.get("loss_mask"))
        aux = {"act_stats": stats}
        if cfg.n_experts:
            loss = loss.map(lambda l, a: l + cfg.router_aux_coef * a,
                            aux_loss)
            aux["aux_loss"] = aux_loss.blocks[0].detach()
        return loss, aux

    return fn


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int):
    """Stand-ins (``meta`` device) of the contiguous decode cache, stacked
    over layers: K and V (L, B, max_seq, KV, Dh), or an MLA model's latent
    and k_rope caches (L, B, max_seq, kv_lora_rank) and (L, B, max_seq,
    qk_rope_dim); int8 under ``kv_cache_bits`` 8, else the compute
    dtype."""
    dt = torch.int8 if cfg.kv_cache_bits == 8 else cfg.activation_dtype()
    L = cfg.n_layers
    if cfg.mla:
        shapes = ((L, batch, max_seq, cfg.kv_lora_rank),
                  (L, batch, max_seq, cfg.qk_rope_dim))
    else:
        shapes = ((L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim),) * 2
    return tuple(torch.empty(s, dtype=dt, device="meta") for s in shapes)


def cache_logical(cfg: ModelConfig):
    if cfg.mla:
        return (("layers", "batch", "kv_seq", None),
                ("layers", "batch", "kv_seq", None))
    sp = ("layers", "batch", "kv_seq", "kv", "head_dim")
    return (sp, sp)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """The zeroed contiguous decode cache of :func:`cache_struct`."""
    return zeros_from(cache_struct(cfg, batch, max_seq), device)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int, *,
            vision_embeds: Optional[torch.Tensor] = None):
    """Run the prompt (after the vision prefix, if given), return
    (last_logits, cache padded to max_seq, pos).  On a placed state and
    placed tokens (``launch.specs.build_prefill_step`` with a mesh) the
    cache is placed by ``cache_logical`` at ``max_seq`` and written layer
    by layer, the logits placed over their vocab split, ``pos`` over
    ``batch``."""
    if is_placed(tokens):
        S = tokens.shape[1] + (0 if vision_embeds is None
                               else vision_embeds.shape[1])
        cache = placed_cache(cache_struct(cfg, tokens.shape[0], max_seq),
                             cache_logical(cfg), tokens)
        logits, cache = forward(cfg, params, tokens, mode="prefill",
                                vision_embeds=vision_embeds, cache=cache)
        return last_logits(logits), cache, placed_pos(tokens, S)
    logits, cache = forward(cfg, params, tokens, mode="prefill",
                            vision_embeds=vision_embeds)
    S = cache[0].shape[2]
    # the sequence (dim 2) padded; the dims after it, from the last, not
    cache = tuple(torch.nn.functional.pad(
        c, (0, 0) * (c.ndim - 3) + (0, max_seq - S)) for c in cache)
    pos = torch.full((tokens.shape[0],), S, dtype=torch.int32,
                     device=tokens.device)
    return logits[:, -1], cache, pos


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos):
    """One token per row.  tokens (B, 1); pos (B,) write positions.

    Returns (logits (B, vocab), cache) — the cache is written in place."""
    logits, new_cache = forward(cfg, params, tokens, mode="decode",
                                cache=cache, cache_pos=pos)
    return last_logits(logits), new_cache


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


def _count(cfg: ModelConfig, ffn: int) -> float:
    attn = (attn_lib.count_mla_params(cfg) if cfg.mla
            else attn_lib.count_gqa_params(cfg))
    per_layer = 2 * cfg.d_model + attn + ffn
    total = cfg.n_layers * per_layer + cfg.d_model
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embed else 2)
    return float(total)


def count_params(cfg: ModelConfig) -> float:
    if cfg.n_experts:
        return _count(cfg, moe_lib.count_moe_params(cfg))
    return _count(cfg, mlp_lib.count_mlp_params(cfg.d_model, cfg.d_ff,
                                                cfg.gated_mlp))


def count_active_params(cfg: ModelConfig) -> float:
    if not cfg.n_experts:
        return count_params(cfg)
    return _count(cfg, moe_lib.count_moe_active_params(cfg))


def residual_taps(cfg: ModelConfig) -> int:
    """Residual taps a training forward makes: one a block."""
    return cfg.n_layers
