"""Model zoo registry: family name -> module with the uniform model API.

Every family module exposes:
  model_defs(cfg[, dtype])        -> nested dict of ParamDef
  forward(cfg, params, tokens, **kw) -> (logits | hidden, new_cache)
  forward_train / loss_fn(cfg)    -> (params, batch, qctx) -> (loss, aux)
  prefill(cfg, params, tokens, max_seq, **kw) -> (logits, cache, pos)
  decode_step(cfg, params, tokens, cache, pos) -> (logits, new_cache)
  cache_struct(cfg, batch, max_seq) / cache_logical(cfg)  (meta stand-ins
  of the decode cache and their logical axes)
  init_cache(cfg, batch, max_seq, device) / count_params(cfg)
  residual_taps(cfg)              -> residual taps a training forward makes
The transformer adds decode_step_paged and (MoE) count_active_params.

As in the reference, the dense, MoE and VLM families share the
decoder-only transformer; ``ssm`` is Mamba2, ``hybrid`` Mamba2 with one
shared attention block, ``encdec`` the Whisper-style encoder-decoder.
"""

from __future__ import annotations


def registry(family: str):
    from repro_torch.models import encdec, hybrid, mamba, transformer
    mods = {
        "dense": transformer,
        "moe": transformer,
        "vlm": transformer,
        "ssm": mamba,
        "hybrid": hybrid,
        "encdec": encdec,
    }
    if family not in mods:
        raise ValueError(f"unknown model family {family!r}")
    return mods[family]
