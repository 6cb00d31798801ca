"""Model zoo registry: family name -> module with the uniform model API.

Every family module exposes:
  model_defs(cfg)                 -> nested dict of ParamDef
  forward(cfg, params, tokens, **kw) -> (logits | hidden, new_cache)
  prefill(cfg, params, tokens, max_seq) -> (logits, cache, pos)
  decode_step(cfg, params, tokens, cache, pos) -> (logits, new_cache)
  decode_step_paged(cfg, params, tokens, cache, ptab, pos)
  init_cache / count_params(cfg) [+ count_active_params for MoE]

The dense, MoE and VLM families share the decoder-only transformer, as in
the reference; the SSM, hybrid and encoder-decoder families are not ported
yet.
"""

from __future__ import annotations

_UNPORTED = ("ssm", "hybrid", "encdec")


def registry(family: str):
    if family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if family in _UNPORTED:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (dense, moe and vlm "
            "are)")
    raise ValueError(f"unknown model family {family!r}")
