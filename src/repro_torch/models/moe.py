"""Mixture-of-Experts: top-k routing with the one-hot einsum dispatch.

Counterpart of ``repro/models/moe.py``'s einsum path (GShard-style one-hot
dispatch and combine, O(T·E·C) memory), which the reference takes on one
device and over a data-only mesh.  Each (token, k) choice takes the next
slot of its expert's capacity buffer in token-major order; a choice past
the buffer's ``C`` slots is dropped.  The load-balance auxiliary loss is
the Switch one.

The router is an fp32 island: its weight is declared fp32 whatever the
working dtype, its logits, softmax and top-k run in fp32, and the DPS
policy leaves it unquantized (``repro_torch.core.policy``).

Not ported: the expert-parallel all-to-all dispatch and its int8
``moe_a2a_bits`` payload, which the reference runs only under a mesh with
a ``"model"`` axis larger than 1.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, act_fn
from repro_torch.models.mlp import mlp_apply, mlp_defs


def moe_defs(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, ParamDef]:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        # the router stays fp32 (a policy fp32 island)
        "router": ParamDef((D, E), dtype=torch.float32),
        "w_in": ParamDef((E, D, Fd), dtype=dtype),
        "w_gate": ParamDef((E, D, Fd), dtype=dtype),
        "w_out": ParamDef((E, Fd, D), dtype=dtype),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(D, cfg.n_shared_experts * Fd, True, dtype)
    return defs


def _router(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """fp32 top-k routing.  x: (T, D) -> (weights (T,K), idx (T,K), probs).

    ``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
    probabilities (lower index first); the two agree wherever the top
    ``K + 1`` probabilities of a token are distinct."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_i, probs


def _aux_fp(cfg: ModelConfig, probs: torch.Tensor, top_i: torch.Tensor):
    """Load-balance ingredients: f_e (dispatch fraction) and p̄_e (mean
    router probability)."""
    f = F.one_hot(top_i, cfg.n_experts).to(torch.float32).mean(dim=(0, 1))
    return f, probs.mean(dim=0)


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor, top_i: torch.Tensor):
    """Switch load-balance loss: E · Σ_e f_e · p̄_e (times top_k)."""
    f, p = _aux_fp(cfg, probs, top_i)
    return cfg.n_experts * torch.sum(f * p) * cfg.top_k


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)   # static, 8-aligned


def _slots(cfg: ModelConfig, top_i: torch.Tensor, C: int):
    """Capacity slot of each (token, k) choice and whether it is kept:
    the number of earlier choices, in token-major order, of the same
    expert; kept where that is below ``C``.  Returns ((T, K), (T, K))."""
    T = top_i.shape[0]
    flat = F.one_hot(top_i, cfg.n_experts).reshape(T * cfg.top_k, -1)
    pos = torch.cumsum(flat, dim=0) - flat                        # (T*K, E)
    pos = torch.sum(pos * flat, dim=-1).reshape(T, cfg.top_k)
    return pos, pos < C


def _moe_einsum(cfg: ModelConfig, p, x2: torch.Tensor):
    T, _ = x2.shape
    E, C = cfg.n_experts, _capacity(T, cfg)
    dt = x2.dtype
    top_w, top_i, probs = _router(cfg, p["router"], x2)
    pos, keep = _slots(cfg, top_i, C)
    disp = (F.one_hot(top_i, E).to(dt)[..., :, None]
            * F.one_hot(torch.clamp(pos, max=C - 1), C).to(dt)[..., None, :]
            * keep[..., None, None].to(dt))                       # (T,K,E,C)
    comb = disp * top_w[..., None, None].to(dt)
    disp = disp.sum(dim=1)                                        # (T, E, C)
    comb = comb.sum(dim=1)

    buf = torch.einsum("tec,td->ecd", disp, x2)                   # (E, C, D)
    h = torch.einsum("ecd,edf->ecf", buf, p["w_in"])
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    h = act_fn(cfg.act, g) * h
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_out"])
    out = torch.einsum("tec,ecd->td", comb, out_buf)
    return out, _aux_loss(cfg, probs, top_i)


def moe_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, D), aux_loss fp32 scalar)."""
    B, S, D = x.shape
    out2, aux = _moe_einsum(cfg, p, x.reshape(B * S, D))
    out = out2.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], x)
    return out, aux


def count_moe_params(cfg: ModelConfig) -> int:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    n = D * E + E * D * Fd * 3
    if cfg.n_shared_experts:
        n += 3 * D * cfg.n_shared_experts * Fd
    return n


def count_moe_active_params(cfg: ModelConfig) -> int:
    D, Fd = cfg.d_model, cfg.moe_d_ff
    n = D * cfg.n_experts + cfg.top_k * D * Fd * 3
    if cfg.n_shared_experts:
        n += 3 * D * cfg.n_shared_experts * Fd
    return n
