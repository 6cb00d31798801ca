"""Attention-free Mamba2 LM (the ``ssm`` family; mamba2-1.3b).

Counterpart of ``repro/models/mamba.py``: embed → L × [pre-norm residual
SSD block] → final norm → tied unembed.  The decode cache is O(1) in the
sequence: an fp32 SSM state (L, B, H, P, N) and the conv tail (L, B, K-1,
C), stacked over layers and written in place by :func:`decode_step`.

Training (:func:`forward_train`, :func:`loss_fn`) follows the
transformer's: the master parameters are cast to the compute dtype inside
each block (the leaves declared fp32 — the norms, ``a_log``, ``dt_bias``,
``d_skip``, ``norm_scale`` — stay fp32), the residual stream is tapped
after every block at the layer's index, and each block runs under
``cfg.remat`` (:func:`repro_torch.models.transformer.remat_call`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixed_point import QuantStats
from repro_torch.dist.sharding import is_placed, logical_constraint
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ParamDef, compute_cast, embed_defs,
                                       embed_lookup, fused_unembed_xent,
                                       last_logits, last_position,
                                       merge_optional, placed_cache,
                                       placed_lm_loss, placed_pos, rms_norm,
                                       unembed, zeros_from)
from repro_torch.models.transformer import (_layer, remat_call, stack_defs,
                                            unbind_layers, write_caches)


def layer_defs(cfg: ModelConfig, dt: torch.dtype) -> Dict[str, Any]:
    return {"norm": ParamDef((cfg.d_model,), (None,), init="ones"),
            "ssm": ssm_lib.ssm_defs(cfg, dt)}


def model_defs(cfg: ModelConfig, dtype: torch.dtype = None) -> Dict[str, Any]:
    """Parameter declarations; the weight matrices take ``dtype`` (the
    compute dtype by default, ``cfg.master_dtype()`` for a trainer)."""
    dt = dtype or cfg.activation_dtype()
    return {
        "embed": embed_defs(cfg.vocab, cfg.d_model, tie=cfg.tie_embed, dtype=dt),
        "layers": stack_defs(cfg.n_layers, layer_defs(cfg, dt)),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int = 0):
    """Stand-ins (``meta`` device) of the decode cache, fp32: (state (L, B,
    H, P, N), conv tail (L, B, K-1, C)), O(1) in the sequence
    (``max_seq`` is unused)."""
    L = cfg.n_layers
    H, P = ssm_lib.n_ssm_heads(cfg), cfg.ssm_head_dim
    cc = ssm_lib.conv_channels(cfg)
    return (torch.empty((L, batch, H, P, cfg.ssm_state), device="meta"),
            torch.empty((L, batch, cfg.ssm_conv - 1, cc), device="meta"))


def cache_logical(cfg: ModelConfig):
    return (("layers", "batch", "heads", None, None),
            ("layers", "batch", None, "tp"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """The zeroed decode cache of :func:`cache_struct`."""
    return zeros_from(cache_struct(cfg, batch, max_seq), device)


def _block(cfg: ModelConfig, p, x, *, mode, cache=None):
    out, new_cache = ssm_lib.ssm_apply(cfg, p["ssm"], rms_norm(x, p["norm"]),
                                       mode=mode, cache=cache)
    # the sequence-parallel residual carry
    return logical_constraint(x + out, "batch", "tp_seq", "embed"), new_cache


def run_layers(cfg: ModelConfig, layers, x, idxs, *, mode, cache=None):
    """Blocks ``idxs`` of the stacked ``layers``, in order (prefill or
    decode).  Decode reads layer ``i``'s ``(state, tail)`` from the stacked
    ``cache`` and writes its new ones there in place, returning ``[]``;
    prefill starts each layer from zeros and returns its ``(state, tail)``
    list.  On placed activations ``layers`` and ``cache`` are the per-layer
    lists of :func:`~repro_torch.models.transformer.unbind_layers` (the
    cache placed, allocated by :func:`prefill`), and both modes write the
    layer's slice in place."""
    new = []
    for i in idxs:
        if is_placed(x):
            x, nc = _block(cfg, layers[i], x, mode=mode, cache=cache[i])
            if mode == "prefill":
                write_caches(cache[i], nc)
            continue
        c = None if mode != "decode" else (cache[0][i], cache[1][i])
        x, nc = _block(cfg, _layer(layers, i), x, mode=mode, cache=c)
        if mode == "decode":
            c[0].copy_(nc[0])
            c[1].copy_(nc[1])
        else:
            new.append(nc)
    return x, new


def stack_caches(per_layer):
    """Prefill's ``(state, tail)`` list stacked over layers, fp32."""
    return (torch.stack([s for s, _ in per_layer]),
            torch.stack([t for _, t in per_layer]).to(torch.float32))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            mode: str = "prefill", cache=None, cache_pos=None,
            hidden_only: bool = False):
    """Returns (logits | hidden, new_cache).  ``mode="prefill"`` unembeds
    the last position only; decode writes ``cache`` in place and hands it
    back.  ``cache_pos`` is unused (the state carries the position)."""
    x = embed_lookup(params["embed"]["tok"], tokens,
                     seq_axis=None).to(cfg.activation_dtype())
    layers, caches = params["layers"], cache
    if is_placed(x):
        layers = unbind_layers(layers, cfg.n_layers)
        caches = unbind_layers(cache, cfg.n_layers)
    x, new = run_layers(cfg, layers, x, range(cfg.n_layers), mode=mode,
                        cache=caches)
    new_cache = (cache if mode == "decode" or is_placed(x)
                 else stack_caches(new))
    x = rms_norm(x, params["final_norm"])
    if hidden_only:
        return x, new_cache
    if mode == "prefill":
        x = last_position(x) if is_placed(x) else x[:, -1:]
    return unembed(x, params["embed"], cfg.vocab), new_cache


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def train_block(cfg: ModelConfig, p, x, qctx, idx: int):
    """One block in train mode on the compute dtype, then the residual tap
    at ``idx``.  Returns (x, QuantStats | None)."""
    x, _ = _block(cfg, compute_cast(cfg, p, layer_defs), x, mode="train")
    if qctx is None:
        return x, None
    return qctx.tap(x, idx)


def forward_train(cfg: ModelConfig, params, tokens: torch.Tensor, qctx=None):
    """Training forward: ``(final-normed hidden (B, S, D), act_stats)``."""
    x = embed_lookup(params["embed"]["tok"], tokens,
                     seq_axis=None).to(cfg.activation_dtype())
    stats = None
    for i, p in enumerate(unbind_layers(params["layers"], cfg.n_layers)):
        x, s = remat_call(cfg, train_block, cfg, p, x, qctx, i)
        stats = merge_optional(stats, s)
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
    """:func:`loss_fn` for a placed state (``launch.specs.build_train_step``
    with a mesh): :func:`forward_train` block for block, each mixer in its
    placed form."""
    return placed_lm_loss(cfg, forward_train)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int):
    """Run the prompt; return (last_logits, cache, pos).  The cache does not
    depend on ``max_seq``.  On a placed state and placed tokens the cache
    is placed by :func:`cache_logical` and written layer by layer (the
    logits placed over their vocab split, ``pos`` over ``batch``)."""
    if is_placed(tokens):
        cache = placed_cache(cache_struct(cfg, tokens.shape[0]),
                             cache_logical(cfg), tokens)
        logits, _ = forward(cfg, params, tokens, mode="prefill", cache=cache)
        return last_logits(logits), cache, placed_pos(tokens, tokens.shape[1])
    logits, cache = forward(cfg, params, tokens, mode="prefill")
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    return logits[:, -1], cache, pos


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos):
    """One token per row.  Returns (logits (B, vocab), cache) — the cache is
    written in place."""
    logits, _ = forward(cfg, params, tokens, mode="decode", cache=cache,
                        cache_pos=pos)
    return last_logits(logits), cache


def count_params(cfg: ModelConfig) -> float:
    per_layer = cfg.d_model + ssm_lib.count_ssm_params(cfg)
    total = cfg.n_layers * per_layer + cfg.d_model
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embed else 2)
    return float(total)


def residual_taps(cfg: ModelConfig) -> int:
    """Residual taps a training forward makes: one a block."""
    return cfg.n_layers
