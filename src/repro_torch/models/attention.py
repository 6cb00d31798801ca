"""Grouped-query attention (GQA/MQA/MHA) for the dense decoder.

Counterpart of ``repro/models/attention.py``.  Call patterns:
  * ``mode="train"``    — causal self-attention, no cache.
  * ``mode="prefill"``  — causal self-attention, returns the populated KV
    cache.
  * ``mode="decode"``   — one new token against a contiguous cache of
    ``max_seq``, or, with ``paged_ptab``, against the paged KV pool of
    :mod:`repro_torch.serve`.

Caches are updated **in place**: the tensors handed in as ``cache`` are
written and handed back (the reference, being functional, returns copies).

Not ported yet: the blockwise (flash-style) path above
:data:`FLASH_THRESHOLD`, cross-attention and MLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import paged_attn
from repro_torch.models.common import ParamDef, apply_rope

NEG_INF = -1e30
FLASH_THRESHOLD = 4096 * 2048          # S_q · S_k above which the reference goes blockwise

# int8 contiguous cache (cfg.kv_cache_bits == 8): values snap to the fixed
# ⟨3,5⟩ grid (range ±4, step 1/32) and are stored as grid integers
_KV_IL, _KV_FL = 3, 5


def _kv_pack(x: torch.Tensor) -> torch.Tensor:
    span = float(1 << (_KV_IL - 1 + _KV_FL))
    y = torch.clamp(x.to(torch.float32) * (1 << _KV_FL), -span, span - 1)
    return torch.round(y).to(torch.int8)


def _cache_read(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if c.dtype == torch.int8:
        return (c.to(torch.float32) * (1.0 / (1 << _KV_FL))).to(dtype)
    return c.to(dtype)


def _cache_write(x: torch.Tensor, cache_dtype: torch.dtype) -> torch.Tensor:
    return _kv_pack(x) if cache_dtype == torch.int8 else x.to(cache_dtype)


def gqa_defs(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, ParamDef]:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((D, H * Dh), dtype=dtype),
        "wk": ParamDef((D, KV * Dh), dtype=dtype),
        "wv": ParamDef((D, KV * Dh), dtype=dtype),
        "wo": ParamDef((H * Dh, D), dtype=dtype),
    }
    if cfg.attn_bias:
        defs["bq"] = ParamDef((H * Dh,), init="zeros", dtype=dtype)
        defs["bk"] = ParamDef((KV * Dh,), init="zeros", dtype=dtype)
        defs["bv"] = ParamDef((KV * Dh,), init="zeros", dtype=dtype)
        defs["bo"] = ParamDef((D,), init="zeros", dtype=dtype)
    return defs


# ---------------------------------------------------------------------------
# Core attention math (q/k/v with fused head dim: (B, S, H, Dh)).
# ---------------------------------------------------------------------------

def _attn_full(q, k, v, *, causal: bool, scale: float):
    """Materialized-scores attention for small S_q·S_k (scores and softmax
    in fp32, probabilities cast to v's dtype for the value product)."""
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kj = torch.arange(Sk, device=q.device)[None, :]
        s = s + torch.where(kj <= qi, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def sdpa(q, k, v, *, causal: bool, scale: float):
    if q.shape[1] * k.shape[1] > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"attention over {q.shape[1]}x{k.shape[1]} positions needs the "
            f"blockwise path, which is not ported yet")
    return _attn_full(q, k, v, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# GQA.
# ---------------------------------------------------------------------------

def gqa_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              *, positions: torch.Tensor, mode: str = "prefill",
              cache: Optional[Tuple[torch.Tensor, ...]] = None,
              cache_pos: Optional[torch.Tensor] = None, causal: bool = True,
              paged_ptab: Optional[torch.Tensor] = None,
              paged_backend: str = "auto"):
    """Grouped-query self-attention.

    ``cache`` = (k, v) each (B, max_seq, KV, Dh); decode writes the new
    token at ``cache_pos`` and attends over [0, cache_pos].

    ``paged_ptab`` (serving, ``mode="decode"`` only) switches to the paged
    KV pool: ``cache`` is then this layer's ``(k_pages, v_pages, k_fmt,
    v_fmt)`` — (n_pages, page, KV, Dh) pools plus (n_pages, 2) per-page
    ⟨IL, FL⟩ rows — and ``paged_ptab`` the (B, P) page table.  Returns
    ``(out, new_cache)``."""
    B, Sq, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, Sq, H, Dh)
    k = k.reshape(B, Sq, KV, Dh)
    v = v.reshape(B, Sq, KV, Dh)

    if cfg.rope_theta > 0:
        # in decode K is rotated at the cache position, Q at `positions`
        kv_pos = positions if mode != "decode" else cache_pos[..., None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)

    scale = 1.0 / math.sqrt(Dh)
    new_cache = None

    if mode == "decode" and paged_ptab is not None:
        out, new_cache = _paged_decode(cache, q, k, v, cache_pos, paged_ptab,
                                       paged_backend, scale)
    elif mode == "decode":
        ck, cv = cache
        rows = torch.arange(B, device=x.device)
        at = cache_pos.to(torch.int64)
        ck[rows, at] = _cache_write(k[:, 0], ck.dtype)
        cv[rows, at] = _cache_write(v[:, 0], cv.dtype)
        new_cache = (ck, cv)
        S = ck.shape[1]
        valid = torch.arange(S, device=x.device)[None, :] <= cache_pos[:, None]
        out = _decode_attn(q.reshape(B, Sq, KV, G, Dh), ck, cv, valid, scale)
    elif mode in ("prefill", "train"):
        if mode == "prefill":
            cdt = torch.int8 if cfg.kv_cache_bits == 8 else k.dtype
            new_cache = (_cache_write(k, cdt), _cache_write(v, cdt))
        kr = torch.repeat_interleave(k, G, dim=2)
        vr = torch.repeat_interleave(v, G, dim=2)
        out = sdpa(q, kr, vr, causal=causal, scale=scale)
    else:
        raise NotImplementedError(f"attention mode {mode!r} is not ported")

    out = out.reshape(B, Sq, H * Dh) @ p["wo"]
    if cfg.attn_bias:
        out = out + p["bo"]
    return out, new_cache


def _paged_decode(cache, q, k, v, cache_pos, ptab, backend, scale):
    """Serving decode against the paged KV pool (repro_torch.serve).

    Writes the new token's K/V into its page — quantized onto the page's
    own ⟨IL, FL⟩ grid when the pool is int8 — then runs the dequantizing
    paged attention over the page table.  Positions ≥ ``cache_pos[b] + 1``
    are masked inside the kernel, so page-table entries past a row's last
    page (the serve layer's trash page) never reach the output.  The pools
    are written in place.
    """
    k_pg, v_pg, k_fmt, v_fmt = cache
    _, ps, KV, Dh = k_pg.shape
    B = q.shape[0]
    int8 = k_pg.dtype == torch.int8

    pos = cache_pos.to(torch.int64)
    slot = pos // ps
    phys = torch.gather(ptab.to(torch.int64), 1, slot[:, None])[:, 0]   # (B,)
    off = pos % ps

    # K and V of the new token go through one quantizer call: (2B, KV·Dh)
    # values under (2B,) formats, each row on its own page's grid
    new = torch.stack([k[:, 0], v[:, 0]]).to(torch.float32).reshape(
        2 * B, KV * Dh)
    if int8:
        rows = torch.cat([k_fmt[phys], v_fmt[phys]])       # (2B, 2) [IL, FL]
        fmt = fxp.FixedPointFormat(rows[:, 0], rows[:, 1])
        new, _ = fxp.wire_quantize(new, fmt, mode=fxp.ROUND_NEAREST,
                                   compute_stats=False)
    new = new.reshape(2, B, KV, Dh)
    # inactive rows all land on the trash page: which one wins there is
    # unspecified and never read
    k_pg[phys, off] = new[0].to(k_pg.dtype)
    v_pg[phys, off] = new[1].to(v_pg.dtype)

    flt = torch.stack([k_fmt[:, 1], v_fmt[:, 1]], dim=1).contiguous()  # FLs
    out = paged_attn.paged_decode_attn(
        q[:, 0].to(torch.float32).contiguous(), k_pg, v_pg, flt, ptab,
        (cache_pos + 1).to(torch.int32), scale=scale, backend=backend)
    return out[:, None].to(q.dtype), (k_pg, v_pg, k_fmt, v_fmt)


def _decode_attn(q, ck, cv, valid, scale):
    """Grouped decode attention: q (B,Sq,KV,G,Dh) over cache (B,S,KV,Dh)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     _cache_read(ck, torch.float32)) * scale
    if valid is not None:
        s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, _cache_read(cv, q.dtype))
    B, Sq = out.shape[0], out.shape[1]
    return out.reshape(B, Sq, -1, out.shape[-1])


def count_gqa_params(cfg: ModelConfig) -> int:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = D * H * Dh * 2 + D * KV * Dh * 2
    if cfg.attn_bias:
        n += H * Dh + 2 * KV * Dh + D
    return n
