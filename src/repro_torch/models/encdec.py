"""Whisper-style encoder-decoder (the ``encdec`` family; whisper-medium).

Counterpart of ``repro/models/encdec.py``.  The conv frontend is a stub, as
in the reference: ``frames`` arrive as precomputed (B, enc_seq, d_model)
frame embeddings.  The encoder is non-causal self-attention; the decoder
is causal self-attention, then cross-attention over the encoder's output.
Sinusoidal positions on both stacks; LayerNorm with bias, GELU (tanh), a
non-gated MLP, attention biases.

Decode keeps two caches a layer, stacked over layers: the growing
self-attention K/V (L, B, max_seq, KV, Dh), written in place, and the
cross-attention K/V (L, B, enc_seq, KV, Dh), computed once at prefill.
Training taps the residual after every encoder block at ``50_000 + i`` and
after every decoder block at ``i``, each block under ``cfg.remat``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixed_point import QuantStats
from repro_torch.dist.sharding import is_placed, logical_constraint, relayout
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (ParamDef, compute_cast, embed_defs,
                                       embed_lookup, fused_unembed_xent,
                                       last_logits, last_position, layer_norm,
                                       merge_optional, placed_cache,
                                       placed_lm_loss, placed_pos,
                                       row_positions, unembed,
                                       whole_but_batch, zeros_from)
from repro_torch.models.transformer import (_layer, remat_call, stack_defs,
                                            unbind_layers, write_caches)

# the encoder's tap index is this plus its layer
ENC_TAP_BASE = 50_000


def sinusoid(S: int, D: int, device=None) -> torch.Tensor:
    return sinusoid_at(torch.arange(S, dtype=torch.int32, device=device), D)


def sinusoid_at(pos: torch.Tensor, D: int) -> torch.Tensor:
    """Sinusoidal embedding rows at integer positions ``pos`` (any shape),
    fp32: (..., D)."""
    dim = torch.arange(D // 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None].to(torch.float32) / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln_defs(d):
    return {"s": ParamDef((d,), (None,), init="ones"),
            "b": ParamDef((d,), (None,), init="zeros")}


def _enc_layer_defs(cfg: ModelConfig, dt: torch.dtype):
    return {
        "ln1": _ln_defs(cfg.d_model),
        "attn": attn_lib.gqa_defs(cfg, dt),
        "ln2": _ln_defs(cfg.d_model),
        "mlp": mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt),
    }


def _dec_layer_defs(cfg: ModelConfig, dt: torch.dtype):
    return {
        "ln1": _ln_defs(cfg.d_model),
        "self_attn": attn_lib.gqa_defs(cfg, dt),
        "lnx": _ln_defs(cfg.d_model),
        "cross_attn": attn_lib.gqa_defs(cfg, dt),
        "ln2": _ln_defs(cfg.d_model),
        "mlp": mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt),
    }


def model_defs(cfg: ModelConfig, dtype: torch.dtype = None) -> Dict[str, Any]:
    """Parameter declarations; the weight matrices and attention biases
    take ``dtype`` (the compute dtype by default, ``cfg.master_dtype()``
    for a trainer), the LayerNorms are fp32."""
    dt = dtype or cfg.activation_dtype()
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model, tie=cfg.tie_embed, dtype=dt),
        "enc_layers": stack_defs(cfg.n_enc_layers, _enc_layer_defs(cfg, dt)),
        "enc_norm": _ln_defs(cfg.d_model),
        "dec_layers": stack_defs(cfg.n_layers, _dec_layer_defs(cfg, dt)),
        "dec_norm": _ln_defs(cfg.d_model),
    }


def _ln(x, p):
    return layer_norm(x, p["s"], p["b"])


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def _enc_block(cfg: ModelConfig, p, x, positions):
    a, _ = attn_lib.gqa_apply(cfg, p["attn"], _ln(x, p["ln1"]),
                              positions=positions, mode="train", causal=False)
    x = x + a
    return x + mlp_lib.mlp_apply(cfg, p["mlp"], _ln(x, p["ln2"]))


def _dec_block(cfg: ModelConfig, p, x, enc_out, positions, *, mode,
               self_cache=None, cross_cache=None, cache_pos=None):
    """One decoder block.  Returns (x, (self K/V, cross K/V)): prefill's
    new caches, or in decode the self cache written in place and the cross
    cache as it was."""
    a, new_self = attn_lib.gqa_apply(
        cfg, p["self_attn"], _ln(x, p["ln1"]), positions=positions,
        mode=mode, cache=self_cache, cache_pos=cache_pos)
    x = x + a
    if mode == "decode":
        c, _ = attn_lib.gqa_apply(cfg, p["cross_attn"], _ln(x, p["lnx"]),
                                  positions=positions, mode="decode_static",
                                  cache=cross_cache)
        new_cross = cross_cache
    else:
        c, new_cross = attn_lib.gqa_apply(
            cfg, p["cross_attn"], _ln(x, p["lnx"]), positions=positions,
            mode=mode, kv_x=enc_out, causal=False)
    x = x + c
    x = x + mlp_lib.mlp_apply(cfg, p["mlp"], _ln(x, p["ln2"]))
    return x, (new_self, new_cross)


def _add_sinusoid(x, dt):
    """``x`` in ``dt`` plus the sinusoids of its whole sequence (placed:
    rank by rank, the sequence gathered)."""
    sin = sinusoid(x.shape[1], x.shape[2], x.device).to(dt)
    if is_placed(x):
        return whole_but_batch(x).map(lambda t: t.to(dt) + sin)
    return x.to(dt) + sin


def _embed_frames(cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    x = _add_sinusoid(frames, cfg.activation_dtype())
    return logical_constraint(x, "batch", "seq", "embed")


def _embed_tokens(cfg: ModelConfig, params, tokens, cache_pos=None):
    """Token embeddings plus sinusoids at their positions (``cache_pos``
    (B,) in decode, 0..S-1 otherwise), in the compute dtype; the sequence
    split (placed: after the sinusoids are added to the whole
    sequence)."""
    x = embed_lookup(params["embed"]["tok"], tokens,
                     seq_axis=None).to(cfg.activation_dtype())
    if cache_pos is not None:
        add = lambda t, pos: t + sinusoid_at(pos, cfg.d_model)[:, None, :].to(
            t.dtype)
        if is_placed(x):
            return x.map(add, relayout(cache_pos, x.spec[:1]))
        return add(x, cache_pos)
    return logical_constraint(_add_sinusoid(x, x.dtype), "batch", "tp_seq",
                              "embed")


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, enc_seq, D), the stubbed frontend's output → the
    encoder's final-normed output (serving: no taps)."""
    x = _embed_frames(cfg, frames)
    positions = _positions(frames.shape[1], frames.device)
    for p in _layers(params["enc_layers"], cfg.n_enc_layers, x):
        x = _enc_block(cfg, p, x, positions)
    return _ln(x, params["enc_norm"])


def _layers(stacked, n: int, x):
    """The ``n`` per-layer slices of a stacked tree: views, unbound once
    per distinct block when ``x`` is placed."""
    if is_placed(x):
        return unbind_layers(stacked, n)
    return [_layer(stacked, i) for i in range(n)]


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int):
    """Stand-ins (``meta`` device) of the decode cache: ``{"self": (k, v)
    (L, B, max_seq, KV, Dh), "cross": (k, v) (L, B, enc_seq, KV, Dh)}``
    (cross length 0 when ``max_seq`` is), int8 under ``kv_cache_bits`` 8,
    else the compute dtype."""
    L = cfg.n_layers
    dt = torch.int8 if cfg.kv_cache_bits == 8 else cfg.activation_dtype()
    self_kv = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    cross_kv = (L, batch, cfg.enc_seq if max_seq else 0, cfg.n_kv_heads,
                cfg.head_dim)
    return {name: tuple(torch.empty(s, dtype=dt, device="meta")
                        for _ in range(2))
            for name, s in (("self", self_kv), ("cross", cross_kv))}


def cache_logical(cfg: ModelConfig):
    sp = ("layers", "batch", "kv_seq", "kv", "head_dim")
    return {"self": (sp, sp), "cross": (sp, sp)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """The zeroed decode cache of :func:`cache_struct`."""
    return zeros_from(cache_struct(cfg, batch, max_seq), device)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            frames: torch.Tensor = None, mode: str = "prefill", cache=None,
            cache_pos=None, hidden_only: bool = False):
    """Returns (logits | hidden, new_cache).  ``frames`` are needed unless
    decoding (the cross K/V are then in ``cache``).  Decode writes the self
    cache in place and hands ``cache`` back."""
    decode = mode == "decode"
    enc_out = None if decode else encode(cfg, params, frames)
    x = _embed_tokens(cfg, params, tokens, cache_pos if decode else None)
    positions = (row_positions(cache_pos) if decode
                 else _positions(x.shape[1], x.device))
    placed = is_placed(x)
    L = cfg.n_layers
    layers = _layers(params["dec_layers"], L, x)
    selfs = crosses = [None] * L
    if cache is not None:
        selfs = _layers(cache["self"], L, x)
        crosses = _layers(cache["cross"], L, x)
    per_layer = []
    for i in range(L):
        x, kv = _dec_block(
            cfg, layers[i], x, enc_out, positions, mode=mode,
            self_cache=selfs[i] if decode else None,
            cross_cache=crosses[i] if decode else None, cache_pos=cache_pos)
        if placed and mode == "prefill":
            write_caches(selfs[i] + crosses[i], kv[0] + kv[1])
        per_layer.append(kv)
    if decode or placed:
        new_cache = cache
    else:
        selfs, crosses = zip(*per_layer)
        new_cache = {"self": tuple(torch.stack(c) for c in zip(*selfs)),
                     "cross": tuple(torch.stack(c) for c in zip(*crosses))}
    x = _ln(x, params["dec_norm"])
    if hidden_only:
        return x, new_cache
    if mode == "prefill":
        x = last_position(x) if placed else x[:, -1:]
    return unembed(x, params["embed"], cfg.vocab), new_cache


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def _tap(x, qctx, idx):
    return (x, None) if qctx is None else qctx.tap(x, idx)


def _enc_train_block(cfg: ModelConfig, p, x, positions, qctx, idx: int):
    return _tap(_enc_block(cfg, compute_cast(cfg, p, _enc_layer_defs), x,
                           positions), qctx, idx)


def _dec_train_block(cfg: ModelConfig, p, x, enc_out, positions, qctx,
                     idx: int):
    x, _ = _dec_block(cfg, compute_cast(cfg, p, _dec_layer_defs), x, enc_out,
                      positions, mode="train")
    return _tap(x, qctx, idx)


def forward_train(cfg: ModelConfig, params, tokens: torch.Tensor,
                  frames: torch.Tensor, qctx=None):
    """Training forward: ``(final-normed decoder hidden (B, S, D),
    act_stats)`` — the encoder's taps merged first, then the decoder's."""
    x = _embed_frames(cfg, frames)
    positions = _positions(frames.shape[1], frames.device)
    stats = None
    for i, p in enumerate(unbind_layers(params["enc_layers"],
                                        cfg.n_enc_layers)):
        x, s = remat_call(cfg, _enc_train_block, cfg, p, x, positions, qctx,
                          ENC_TAP_BASE + i)
        stats = merge_optional(stats, s)
    enc_out = _ln(x, params["enc_norm"])

    x = _embed_tokens(cfg, params, tokens)
    positions = _positions(x.shape[1], x.device)
    for i, p in enumerate(unbind_layers(params["dec_layers"], cfg.n_layers)):
        x, s = remat_call(cfg, _dec_train_block, cfg, p, x, enc_out,
                          positions, qctx, i)
        stats = merge_optional(stats, s)
    x = _ln(x, params["dec_norm"])
    return x, stats or QuantStats.zero(device=x.device)


def loss_fn(cfg: ModelConfig):
    """(params, batch, qctx) -> (loss, aux) for qtrain.make_train_step; the
    batch carries ``frames`` (B, enc_seq, D) beside the tokens."""

    def fn(params, batch, qctx=None):
        tokens = batch["tokens"]
        hidden, stats = forward_train(cfg, params, tokens[:, :-1],
                                      batch["frames"], qctx)
        loss = fused_unembed_xent(hidden, params["embed"], cfg.vocab,
                                  tokens[:, 1:], batch.get("loss_mask"))
        return loss, {"act_stats": stats}

    return fn


def placed_loss_fn(cfg: ModelConfig):
    """:func:`loss_fn` for a placed state, ``frames`` placed over the batch
    beside the tokens: the encoder (its residual whole on every model rank,
    as the reference constrains it) and the decoder (self- and
    cross-attention, biases) in their placed forms, the taps at their
    indices."""
    return placed_lm_loss(cfg, forward_train, "frames")


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int, *,
            frames: torch.Tensor = None):
    """Encode ``frames``, run the prompt; return (last_logits, cache with
    the self cache padded to ``max_seq``, pos).  On a placed state, placed
    tokens and frames the cache is placed by :func:`cache_logical` (the
    self cache at ``max_seq``) and written layer by layer: the cross K/V
    computed once here."""
    if is_placed(tokens):
        cache = placed_cache(cache_struct(cfg, tokens.shape[0], max_seq),
                             cache_logical(cfg), tokens)
        logits, _ = forward(cfg, params, tokens, frames=frames,
                            mode="prefill", cache=cache)
        return last_logits(logits), cache, placed_pos(tokens, tokens.shape[1])
    logits, cache = forward(cfg, params, tokens, frames=frames,
                            mode="prefill")
    S = tokens.shape[1]
    cache["self"] = tuple(torch.nn.functional.pad(
        c, (0, 0, 0, 0, 0, max_seq - S)) for c in cache["self"])
    pos = torch.full((tokens.shape[0],), S, dtype=torch.int32,
                     device=tokens.device)
    return logits[:, -1], cache, pos


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos):
    """One token per row.  Returns (logits (B, vocab), cache) — the self
    cache is written in place."""
    logits, _ = forward(cfg, params, tokens, mode="decode", cache=cache,
                        cache_pos=pos)
    return last_logits(logits), cache


def count_params(cfg: ModelConfig) -> float:
    attn = attn_lib.count_gqa_params(cfg)
    mlp = mlp_lib.count_mlp_params(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    enc = cfg.n_enc_layers * (4 * cfg.d_model + attn + mlp)
    dec = cfg.n_layers * (6 * cfg.d_model + 2 * attn + mlp)
    total = enc + dec + 4 * cfg.d_model
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embed else 2)
    return float(total)


def residual_taps(cfg: ModelConfig) -> int:
    """Residual taps a training forward makes: one an encoder block and one
    a decoder block."""
    return cfg.n_enc_layers + cfg.n_layers
