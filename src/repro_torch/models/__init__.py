"""Model zoo registry: family name -> module with the uniform model API.

Every family module exposes:
  model_defs(cfg)                 -> nested dict of ParamDef
  forward(cfg, params, tokens, **kw) -> (logits | hidden, new_cache)
  prefill(cfg, params, tokens, max_seq) -> (logits, cache, pos)
  decode_step(cfg, params, tokens, cache, pos) -> (logits, new_cache)
  decode_step_paged(cfg, params, tokens, cache, ptab, pos)
  init_cache / count_params(cfg)

Only the dense decoder is ported so far.
"""

from __future__ import annotations

_UNPORTED = ("moe", "vlm", "ssm", "hybrid", "encdec")


def registry(family: str):
    if family == "dense":
        from repro_torch.models import transformer
        return transformer
    if family in _UNPORTED:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (dense only)")
    raise ValueError(f"unknown model family {family!r}")
