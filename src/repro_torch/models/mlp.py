"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (squared-ReLU)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import is_placed, logical_constraint
from repro_torch.models.common import (ParamDef, act_fn, placed_matmul,
                                       whole_but_batch)


def mlp_defs(d_model: int, d_ff: int, gated: bool,
             dtype: torch.dtype) -> Dict[str, ParamDef]:
    defs = {
        "w_in": ParamDef((d_model, d_ff), ("fsdp", "tp"), dtype=dtype),
        "w_out": ParamDef((d_ff, d_model), ("tp", "fsdp"), dtype=dtype),
    }
    if gated:
        defs["w_gate"] = ParamDef((d_model, d_ff), ("fsdp", "tp"),
                                  dtype=dtype)
    return defs


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: Optional[str] = None) -> torch.Tensor:
    act = act or cfg.act
    if is_placed(x):
        return _mlp_apply_placed(act, p, x)
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act_fn(act, x @ p["w_gate"]) * h
    else:
        h = act_fn(act, h)
    h = logical_constraint(h, "batch", "seq", "tp")
    return logical_constraint(h @ p["w_out"], "batch", "tp_seq", "embed")


def _mlp_apply_placed(act: str, p, x):
    """:func:`mlp_apply` rank by rank: the sequence gathered, ``w_in`` and
    ``w_gate`` column-parallel (their FSDP rows gathered), ``w_out``
    row-parallel, its partial sums reduce-scattered (or summed) over the
    model axis by the output's layout."""
    xs = whole_but_batch(x)
    h = placed_matmul(xs, p["w_in"])
    if "w_gate" in p:
        h = placed_matmul(xs, p["w_gate"]).map(
            lambda g, hh: act_fn(act, g) * hh, h)
    else:
        h = h.map(lambda hh: act_fn(act, hh))
    h = logical_constraint(h, "batch", "seq", "tp")
    return logical_constraint(placed_matmul(h, p["w_out"]), "batch", "tp_seq",
                              "embed")


def count_mlp_params(d_model: int, d_ff: int, gated: bool) -> int:
    return d_model * d_ff * (3 if gated else 2)
