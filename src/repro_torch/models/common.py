"""Shared model substrate: param defs, norms, RoPE, activations, embeddings.

Counterpart of ``repro/models/common.py``.  Parameters are declared once as
:class:`ParamDef` (shape + initializer + dtype) and materialized by
:func:`init_params` into a nested dict of tensors with the reference's keys
and layouts — weights are ``(in, out)`` and applied as ``x @ w`` — so a
parameter tree of the reference converts leaf by leaf
(:mod:`repro_torch.convert`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape and init spec."""

    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # stddev multiplier (normal) / stddev (embed)
    dtype: torch.dtype = torch.float32


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _init_one(d: ParamDef, device, generator: torch.Generator) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        w = torch.empty(d.shape, dtype=torch.float32, device=device)
        w.normal_(generator=generator)
        return w.mul_(d.scale).to(d.dtype)
    if d.init == "normal":
        # truncated normal on [-2, 2] by inverse CDF, fan-in scaled
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        w = torch.empty(d.shape, dtype=torch.float32, device=device)
        w.uniform_(lo, 1.0 - lo, generator=generator)
        w.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0) * std)
        return w.clamp_(-2.0 * std, 2.0 * std).to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


def init_params(defs, device, generator: torch.Generator) -> Any:
    """Materialize a nested dict of ParamDef into tensors on ``device``.

    ``generator`` must live on ``device``; leaves are drawn in the dict's
    (insertion) order, so the result is a function of the seed alone.
    """
    if is_def(defs):
        return _init_one(defs, device, generator)
    return {k: init_params(v, device, generator) for k, v in defs.items()}


def map_defs(fn, defs):
    if is_def(defs):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


# ---------------------------------------------------------------------------
# Normalization / activations (fp32 islands).
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":       # squared ReLU (nemotron-4)
        r = torch.relu(x)
        return r * r
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freqs_np(head_dim: int, theta: float) -> np.ndarray:
    # computed once on the host in float64 and rounded to fp32, so the CPU
    # and the card rotate by the same angles
    return (1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                             / head_dim))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: str) -> torch.Tensor:
    return torch.from_numpy(_rope_freqs_np(head_dim, theta)).to(device)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None
               ) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,) fp32 (kept per device, so
    a forward pass makes no host-to-device copy for them)."""
    return _rope_freqs_on(head_dim, float(theta), str(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x``: (..., S, H, D) with positions (..., S) broadcastable.

    Pairing convention: (x[..., :D/2], x[..., D/2:]) rotated jointly —
    llama-style "rotate_half".  Math in fp32.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv       # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------

def padded_vocab(vocab: int, multiple: int = 512) -> int:
    """Vocab padded to a multiple (128256 → 128512); the pad columns are
    masked to -1e30 in :func:`unembed`, so they carry zero probability."""
    return -(-vocab // multiple) * multiple


def embed_defs(vocab: int, d_model: int, tie: bool = True,
               dtype: torch.dtype = torch.float32) -> Dict[str, ParamDef]:
    vp = padded_vocab(vocab)
    defs = {"tok": ParamDef((vp, d_model), init="embed", scale=0.02,
                            dtype=dtype)}
    if not tie:
        defs["unembed"] = ParamDef((d_model, vp), init="normal", dtype=dtype)
    return defs


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens.to(torch.int64)]


# key under which a caller may park an fp32 copy of a low-precision tied
# embedding table, so unembed does not cast the table on every call
TOK_F32 = "tok_f32"


def unembed(x: torch.Tensor, params: Dict[str, torch.Tensor],
            vocab: int) -> torch.Tensor:
    """Project hidden states to logits (fp32); mask vocab-padding columns.

    The product runs in fp32 against the fp32 cast of the table.  A caller
    that unembeds often (the serving engine) holds that cast once under
    ``params[TOK_F32]``; without it the table is cast per call.
    """
    xf = x.to(torch.float32)
    if "unembed" in params:
        logits = xf @ params["unembed"].to(torch.float32)
    else:
        w = params.get(TOK_F32)
        if w is None:
            w = params["tok"].to(torch.float32)
        logits = xf @ w.T
    if logits.shape[-1] != vocab:
        logits[..., vocab:] = -1e30
    return logits
