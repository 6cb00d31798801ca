"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (squared-ReLU)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, act_fn


def mlp_defs(d_model: int, d_ff: int, gated: bool,
             dtype: torch.dtype) -> Dict[str, ParamDef]:
    defs = {
        "w_in": ParamDef((d_model, d_ff), dtype=dtype),
        "w_out": ParamDef((d_ff, d_model), dtype=dtype),
    }
    if gated:
        defs["w_gate"] = ParamDef((d_model, d_ff), dtype=dtype)
    return defs


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: Optional[str] = None) -> torch.Tensor:
    act = act or cfg.act
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act_fn(act, x @ p["w_gate"]) * h
    else:
        h = act_fn(act, h)
    return h @ p["w_out"]


def count_mlp_params(d_model: int, d_ff: int, gated: bool) -> int:
    return d_model * d_ff * (3 if gated else 2)
