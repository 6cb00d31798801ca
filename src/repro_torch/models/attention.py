"""Attention: grouped-query (GQA/MQA/MHA) and multi-head latent (MLA).

Counterpart of ``repro/models/attention.py``.  Call patterns:
  * ``mode="train"``    — causal self-attention, no cache.
  * ``mode="prefill"``  — causal self-attention, returns the populated KV
    cache.
  * ``mode="decode"``   — one new token against a contiguous cache of
    ``max_seq``, or, with ``paged_ptab``, against the paged KV pool of
    :mod:`repro_torch.serve`.
  * ``mode="decode_static"`` — attend over a fixed (B, S, KV, Dh) cache
    with no write and no mask (the encoder-decoder's cross cache).
  * ``kv_x=...``        — cross-attention: K and V from ``kv_x``, no RoPE
    (the caller passes ``causal=False``).

Caches are updated **in place**: the tensors handed in as ``cache`` are
written and handed back (the reference, being functional, returns copies).

Train and prefill attention run blockwise with an online softmax
(:func:`_attn_flash`) once S_q·S_k passes :data:`FLASH_THRESHOLD`, so the
scores held at a time are O(S_q · block) instead of O(S_q · S_k).

MLA (DeepSeek-V2) trains and prefills in the expanded form (per-head K and
V up-projected from the latent, through :func:`sdpa`) and decodes in the
*absorbed* form: scores are taken directly against the compressed latent
cache, so a decode step reads O(kv_lora + rope) a token instead of
O(heads × head_dim).  MLA has no paged path (nor has the reference's).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixed_point as fxp
from repro_torch.core import tagging
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (Placed, is_placed, logical_constraint,
                                       model_axis_size, relayout)
from repro_torch.kernels import paged_attn
from repro_torch.models.common import (ParamDef, add_bias, apply_rope,
                                       placed_matmul, rms_norm,
                                       whole_but_batch)

NEG_INF = -1e30
FLASH_THRESHOLD = 4096 * 2048          # S_q · S_k above which attention goes blockwise
FLASH_BLOCK = 1024

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
        "wq": ParamDef((D, H * Dh), ("fsdp", "tp"), dtype=dtype),
        "wk": ParamDef((D, KV * Dh), ("fsdp", "tp"), dtype=dtype),
        "wv": ParamDef((D, KV * Dh), ("fsdp", "tp"), dtype=dtype),
        "wo": ParamDef((H * Dh, D), ("tp", "fsdp"), dtype=dtype),
    }
    if cfg.attn_bias:
        defs["bq"] = ParamDef((H * Dh,), ("tp",), init="zeros", dtype=dtype)
        defs["bk"] = ParamDef((KV * Dh,), ("tp",), init="zeros", dtype=dtype)
        defs["bv"] = ParamDef((KV * Dh,), ("tp",), init="zeros", dtype=dtype)
        defs["bo"] = ParamDef((D,), (None,), init="zeros", dtype=dtype)
    return defs


# ---------------------------------------------------------------------------
# Core attention math (q/k/v with fused head dim: (B, S, H, Dh)).
# ---------------------------------------------------------------------------

def _attn_full(q, k, v, *, causal: bool, scale: float,
               q_start: Optional[int] = None):
    """Materialized-scores attention for small S_q·S_k (scores and softmax
    in fp32, probabilities cast to v's dtype for the value product).
    ``q_start``: the position of q's first row among k's (the last S_q
    positions by default)."""
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        q0 = Sk - Sq if q_start is None else q_start
        qi = torch.arange(Sq, device=q.device)[:, None] + q0
        kj = torch.arange(Sk, device=q.device)[None, :]
        s = s + torch.where(kj <= qi, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def _flash_block(q, k_blk, v_blk, m, l, acc, *, j0: int, sk: int,
                 causal: bool, scale: float, q0: int):
    """One K/V block of :func:`_attn_flash`: the running max ``m``, sum
    ``l`` and unnormalized output ``acc`` (fp32) updated by ``block``
    positions starting at ``j0``."""
    block = k_blk.shape[1]
    s = torch.einsum("bqhd,bjhd->bhqj", q.to(torch.float32),
                     k_blk.to(torch.float32)) * scale
    sq = q.shape[1]
    kj = j0 + torch.arange(block, device=q.device)
    valid = (kj < sk)[None, :]
    if causal:
        qi = torch.arange(sq, device=q.device) + q0          # global positions
        valid = valid & (kj[None, :] <= qi[:, None])
    s = torch.where(valid, s, NEG_INF)
    new_m = torch.maximum(m, s.amax(dim=-1))                   # (B,H,Sq)
    p = torch.exp(s - new_m[..., None]) * valid                # masked exp
    corr = torch.exp(m - new_m)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqj,bjhd->bhqd", p.to(v_blk.dtype).to(torch.float32),
                      v_blk.to(torch.float32))
    return new_m, l, acc * corr[..., None] + pv


def _attn_flash(q, k, v, *, causal: bool, scale: float,
                block: int = FLASH_BLOCK, q_start: Optional[int] = None):
    """Blockwise online-softmax attention over K/V blocks of ``block``
    positions (the last padded and masked); ``q_start`` as in
    :func:`_attn_full`.

    Each block runs under ``torch.utils.checkpoint``: the backward
    recomputes a block's (B, H, S_q, block) fp32 scores and probabilities
    instead of holding every block's.  ``v`` may be narrower than q/k."""
    B, Sq, H, _ = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[1]
    block = min(block, Sk)
    nb = -(-Sk // block)
    pad = nb * block - Sk
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    for i in range(nb):
        sl = slice(i * block, (i + 1) * block)
        m, l, acc = checkpoint(_flash_block, q, kp[:, sl], vp[:, sl], m, l,
                               acc, j0=i * block, sk=Sk, causal=causal,
                               scale=scale,
                               q0=Sk - Sq if q_start is None else q_start,
                               use_reentrant=False,
                               preserve_rng_state=False)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                     # (B,Sq,H,Dv)


def sdpa(q, k, v, *, causal: bool, scale: float,
         q_start: Optional[int] = None):
    if q.shape[1] * k.shape[1] > FLASH_THRESHOLD:
        return _attn_flash(q, k, v, causal=causal, scale=scale,
                           q_start=q_start)
    return _attn_full(q, k, v, causal=causal, scale=scale, q_start=q_start)


def _heads_on_model(n_heads: int) -> bool:
    m = model_axis_size()
    return m > 1 and n_heads % m == 0


def _constrain_qkv(q, k, v, n_heads, batch2d: bool = False):
    """The reference's layout decision for q, k, v (B, S, H, Dh): heads on
    the model axis when it divides them; else, with ``batch2d``, the batch
    over (data × model); else the query sequence on the model axis with
    K/V replicated there.  A layout only: the values are unchanged."""
    if _heads_on_model(n_heads):
        q = logical_constraint(q, "batch", None, "heads", None)
        k = logical_constraint(k, "batch", None, "heads", None)
        v = logical_constraint(v, "batch", None, "heads", None)
    elif batch2d:
        q = logical_constraint(q, "batch2d", None, None, None)
        k = logical_constraint(k, "batch2d", None, None, None)
        v = logical_constraint(v, "batch2d", None, None, None)
    else:
        q = logical_constraint(q, "batch", "tp_seq", None, None)
        k = logical_constraint(k, "batch", None, None, None)
        v = logical_constraint(v, "batch", None, None, None)
    return q, k, v


# ---------------------------------------------------------------------------
# GQA.
# ---------------------------------------------------------------------------

def gqa_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              *, positions: torch.Tensor, mode: str = "prefill",
              cache: Optional[Tuple[torch.Tensor, ...]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              kv_x: Optional[torch.Tensor] = None, causal: bool = True,
              paged_ptab: Optional[torch.Tensor] = None,
              paged_backend: str = "auto"):
    """Grouped-query attention.  ``kv_x`` (B, Sk, D) switches to
    cross-attention: K and V are its projections, unrotated (the caller
    passes ``causal=False``).

    ``cache`` = (k, v) each (B, max_seq, KV, Dh); decode writes the new
    token at ``cache_pos`` and attends over [0, cache_pos];
    ``decode_static`` attends over all of it and writes nothing.

    ``paged_ptab`` (serving, ``mode="decode"`` only) switches to the paged
    KV pool: ``cache`` is then this layer's ``(k_pages, v_pages, k_fmt,
    v_fmt)`` — (n_pages, page, KV, Dh) pools plus (n_pages, 2) per-page
    ⟨IL, FL⟩ rows — and ``paged_ptab`` the (B, P) page table.  Returns
    ``(out, new_cache)``."""
    if is_placed(x):
        if mode in ("decode", "decode_static"):
            return _gqa_decode_placed(cfg, p, x, positions, cache,
                                      cache_pos if mode == "decode" else None)
        return _gqa_train_placed(cfg, p, x, positions, kv_x, causal,
                                 cache=mode == "prefill")
    B, Sq, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV

    src = x if kv_x is None else kv_x
    Sk = src.shape[1]
    static = mode == "decode_static"        # reads a cache; needs no new K/V

    q = x @ p["wq"]
    if cfg.attn_bias:
        q = q + p["bq"]
    q = q.reshape(B, Sq, H, Dh)
    if not static:
        k = src @ p["wk"]
        v = src @ p["wv"]
        if cfg.attn_bias:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(B, Sk, KV, Dh)
        v = v.reshape(B, Sk, KV, Dh)

    if kv_x is None and cfg.rope_theta > 0:
        # in decode K is rotated at the cache position, Q at `positions`
        q = apply_rope(q, positions, cfg.rope_theta)
        if not static:
            kv_pos = positions if mode != "decode" else cache_pos[..., None]
            k = apply_rope(k, kv_pos, cfg.rope_theta)

    scale = 1.0 / math.sqrt(Dh)
    new_cache = None

    if static:
        ck, cv = cache
        out = _decode_attn(q.reshape(B, Sq, KV, G, Dh), ck, cv, None, scale)
    elif mode == "decode" and paged_ptab is not None:
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
        q, kr, vr = _constrain_qkv(q, kr, vr, H, cfg.attn_batch2d)
        out = sdpa(q, kr, vr, causal=causal, scale=scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    out = out.reshape(B, Sq, H * Dh) @ p["wo"]
    if cfg.attn_bias:
        out = out + p["bo"]
    return logical_constraint(out, "batch", "tp_seq", "embed"), new_cache


def _split_heads(t: Placed, n: int, dh: int) -> Placed:
    """(..., n·dh) → (..., n, dh) rank by rank: the model split of the
    fused dim becomes a split of the heads when it divides them, else the
    dim is gathered first (a rank's columns would cut a head)."""
    e = t.spec[-1]
    ways = math.prod(sharding._axis_sizes(t.mesh)[a]
                     for a in sharding._entry_axes(e))
    if ways > 1 and n % ways:
        t, e = relayout(t, t.spec[:-1] + (None,)), None
    return t.map(lambda b: b.reshape(*b.shape[:-1], -1, dh),
                 spec=t.spec[:-1] + (e, None))


def _project(xs: Placed, p, w: str, bias: str, n: int, dh: int) -> Placed:
    """A column-parallel projection of ``xs`` split into ``n`` heads of
    ``dh``, each rank adding its block of the bias (when the layer has
    one) after its product."""
    t = placed_matmul(xs, p[w])
    if bias in p:
        t = add_bias(t, p[bias])
    return _split_heads(t, n, dh)


def _attend_placed(q: Placed, k: Placed, v: Placed, *, causal: bool,
                   scale: float) -> Placed:
    """:func:`sdpa` on each rank's rows and heads (a rank's query rows
    start at its block's origin), the heads fused back: (B, S, H·Dv)."""
    out = Placed([sdpa(qb, kb, vb, causal=causal, scale=scale,
                       q_start=q.geometry(i)[0][1])
                  for i, (qb, kb, vb) in enumerate(zip(q.blocks, k.blocks,
                                                       v.blocks))],
                 q.spec, q.mesh)
    return out.map(lambda b: b.reshape(*b.shape[:2], -1),
                   spec=out.spec[:3])


def _out_proj_placed(p, out: Placed) -> Placed:
    """``wo`` row-parallel (or whole, on a sequence split), its partial
    sums taken by the output's layout, then ``bo`` added once, after the
    sum."""
    out = logical_constraint(placed_matmul(out, p["wo"]), "batch", "tp_seq",
                             "embed")
    return add_bias(out, p["bo"]) if "bo" in p else out


def _gqa_train_placed(cfg: ModelConfig, p, x: Placed, positions,
                      kv_x: Optional[Placed] = None, causal: bool = True,
                      cache: bool = False):
    """Training (and prefill) attention on placed activations: the
    sequence gathered, q/k/v column-parallel (local heads when the model
    axis divides them; K/V gathered over it when it cuts a KV head), each
    rank's block of ``bq``/``bk``/``bv`` added to its columns, RoPE as it
    is, the reference's layout decision (:func:`_constrain_qkv`) as a real
    re-layout, :func:`sdpa` on each rank's rows and heads, and ``wo``
    row-parallel.  ``kv_x``: cross-attention, K and V from its (gathered)
    sequence, unrotated.  Returns ``(out, None)``, or with ``cache``
    (prefill) ``(out, (K, V))``: each rank's heads of the keys and values,
    packed for an int8 cache under ``kv_cache_bits`` 8."""
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xs = whole_but_batch(x)
    src = xs if kv_x is None else whole_but_batch(kv_x)
    q = _project(xs, p, "wq", "bq", H, Dh)
    k = _project(src, p, "wk", "bk", KV, Dh)
    v = _project(src, p, "wv", "bv", KV, Dh)
    if kv_x is None and cfg.rope_theta > 0:
        q = q.map(lambda t: apply_rope(t, positions, cfg.rope_theta))
        k = k.map(lambda t: apply_rope(t, positions, cfg.rope_theta))
    rep = lambda t: t.map(lambda b: torch.repeat_interleave(b, H // KV, dim=2))
    qc, kr, vr = _constrain_qkv(q, rep(k), rep(v), H, cfg.attn_batch2d)
    out = _attend_placed(qc, kr, vr, causal=causal, scale=1.0 / math.sqrt(Dh))
    out = _out_proj_placed(p, out)
    if not cache:
        return out, None
    cdt = torch.int8 if cfg.kv_cache_bits == 8 else k.dtype
    return out, (k.map(lambda t: _cache_write(t, cdt)),
                 v.map(lambda t: _cache_write(t, cdt)))


def _rope_placed(cfg: ModelConfig, t: Placed, positions: Placed) -> Placed:
    """RoPE on each rank's rows at their own positions (B, S)."""
    return t.map(lambda b, pb: apply_rope(b, pb, cfg.rope_theta),
                 relayout(positions, t.spec[:1] + (None,)))


def _valid(pos: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S): the cache positions at or before each row's ``pos``."""
    return torch.arange(S, device=pos.device)[None, :] <= pos[:, None]


def _decode_heads(q, ck, cv, valid, h0: int, k0: int, G: int, scale):
    """One rank's decode attention: its query heads ``[h0, h0 + Hl)`` (B,
    Sq, Hl, Dh) over its cache block's KV heads from ``k0`` (B, S, KVl,
    Dh).  Whole groups of G query heads over the block's own KV heads
    take the grouped form; otherwise each query head reads its KV head
    (``h // G``) picked out of the block."""
    B, Sq, Hl, Dh = q.shape
    KVl = ck.shape[2]
    if h0 == k0 * G and Hl == KVl * G:
        return _decode_attn(q.reshape(B, Sq, KVl, G, Dh), ck, cv, valid,
                            scale)
    idx = torch.arange(h0, h0 + Hl, device=q.device) // G - k0
    return _decode_attn(q.reshape(B, Sq, Hl, 1, Dh), ck.index_select(2, idx),
                        cv.index_select(2, idx), valid, scale)


def _gqa_decode_placed(cfg: ModelConfig, p, x: Placed, positions, cache,
                       cache_pos):
    """Decode on placed activations (B, 1, D), each rank on its rows of
    the batch and its query heads: q (and, with ``cache_pos``, the new
    token's K and V) column-parallel as in training, rotated at each row's
    position; the new K and V written in place into each rank's block of
    the cache ``(k, v)`` (B, S, KV, Dh) at ``cache_pos`` (each rank its
    rows and its KV heads); attention over the block's positions up to
    ``cache_pos`` (or, ``cache_pos`` None — the static cross cache — over
    all of them); ``wo`` row-parallel.  Returns ``(out, cache)``."""
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache
    # the rows of the batch as the cache holds them, the rest whole
    xs = relayout(x, ck.spec[:1] + (None, None))
    q = _project(xs, p, "wq", "bq", H, Dh)
    rope = cache_pos is not None and cfg.rope_theta > 0
    if rope:
        q = _rope_placed(cfg, q, positions)
    if cache_pos is not None:
        k = _project(xs, p, "wk", "bk", KV, Dh)
        v = _project(xs, p, "wv", "bv", KV, Dh)
        if rope:
            k = _rope_placed(cfg, k, positions)
        row = lambda t: t.map(lambda b: _cache_write(b[:, 0], ck.dtype),
                              spec=t.spec[:1] + t.spec[2:])
        sharding.write_rows(ck, row(k), cache_pos)
        sharding.write_rows(cv, row(v), cache_pos)
        pos = relayout(cache_pos, ck.spec[:1])
    scale = 1.0 / math.sqrt(Dh)
    out = []
    for i, (qb, kb, vb) in enumerate(zip(q.blocks, ck.blocks, cv.blocks)):
        valid = None if cache_pos is None else _valid(pos.blocks[i],
                                                      kb.shape[1])
        o = _decode_heads(qb, kb, vb, valid, q.geometry(i)[0][2],
                          ck.geometry(i)[0][2], H // KV, scale)
        out.append(o.reshape(*o.shape[:2], -1))
    out = Placed(out, q.spec[:2] + (q.spec[2],), x.mesh)
    return _out_proj_placed(p, out), cache


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
    bits = 8 if int8 else 0
    new = tagging.tag(new.reshape(2, B, KV, Dh), "kv_page", domain="kv_cache",
                      stage="write", bits=bits)
    # inactive rows all land on the trash page: which one wins there is
    # unspecified and never read
    k_pg[phys, off] = new[0].to(k_pg.dtype)
    v_pg[phys, off] = new[1].to(v_pg.dtype)

    flt = torch.stack([k_fmt[:, 1], v_fmt[:, 1]], dim=1).contiguous()  # FLs
    tagging.tag(k_pg, "kv_page", domain="kv_cache", stage="read", bits=bits)
    tagging.tag(v_pg, "kv_page", domain="kv_cache", stage="read", bits=bits)
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


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention.
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, ParamDef]:
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamDef((D, qr), ("fsdp", None), dtype=dtype),
        "q_norm": ParamDef((qr,), (None,), init="ones"),
        "wq_b": ParamDef((qr, H * (dn + dr)), (None, "tp"), dtype=dtype),
        "wkv_a": ParamDef((D, kvr + dr), ("fsdp", None), dtype=dtype),
        "kv_norm": ParamDef((kvr,), (None,), init="ones"),
        # decoupled up-projections, so that decode can absorb them
        "w_uk": ParamDef((kvr, H, dn), (None, "tp", None), dtype=dtype),
        "w_uv": ParamDef((kvr, H, dv), (None, "tp", None), dtype=dtype),
        "wo": ParamDef((H * dv, D), ("tp", "fsdp"), dtype=dtype),
    }


def _mla_qkr(cfg: ModelConfig, p, x, positions):
    """The query path and the latent / k_rope projection, shared by every
    mode: (q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,kvr), k_rope
    (B,S,dr)), the rope parts rotated at ``positions``."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    q_lat = rms_norm(x @ p["wq_a"], p["q_norm"])
    q = (q_lat @ p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :kvr], p["kv_norm"])
    k_rope = apply_rope(kv[..., None, kvr:], positions, cfg.rope_theta)[:, :, 0]
    c_kv = logical_constraint(c_kv, "batch", None, None)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              *, positions: torch.Tensor, mode: str = "prefill",
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None):
    """MLA attention.  ``cache`` = (c_kv (B, max_seq, kvr), k_rope (B,
    max_seq, dr)); decode writes the new token's latents at ``cache_pos``
    (in place) and attends over [0, cache_pos] in the absorbed form.
    Returns ``(out, new_cache)``."""
    if is_placed(x):
        if mode == "decode":
            return _mla_decode_placed(cfg, p, x, positions, cache, cache_pos)
        return _mla_train_placed(cfg, p, x, positions,
                                 cache=mode == "prefill")
    B, Sq, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(dn + dr)

    q_nope, q_rope, c_kv, k_rope = _mla_qkr(cfg, p, x, positions)

    new_cache = None
    if mode == "decode":
        cc, cr = cache
        rows = torch.arange(B, device=x.device)
        at = cache_pos.to(torch.int64)
        cc[rows, at] = _cache_write(c_kv[:, 0], cc.dtype)
        cr[rows, at] = _cache_write(k_rope[:, 0], cr.dtype)
        new_cache = (cc, cr)
        # absorbed decode: the query projected into the latent space and
        # scored against the latent cache; scores in fp32
        q_c = torch.einsum("bthd,rhd->bthr", q_nope, p["w_uk"])   # (B,1,H,kvr)
        s = (torch.einsum("bthr,bsr->bhts", q_c.to(torch.float32),
                          _cache_read(cc, torch.float32))
             + torch.einsum("bthe,bse->bhts", q_rope.to(torch.float32),
                            _cache_read(cr, torch.float32))) * scale
        valid = (torch.arange(cc.shape[1], device=x.device)[None, :]
                 <= cache_pos[:, None])
        s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
        probs = torch.softmax(s, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bsr->bthr", probs, _cache_read(cc, x.dtype))
        out = torch.einsum("bthr,rhd->bthd", ctx, p["w_uv"])       # (B,1,H,dv)
    elif mode in ("prefill", "train"):
        if mode == "prefill":
            cdt = torch.int8 if cfg.kv_cache_bits == 8 else c_kv.dtype
            new_cache = (_cache_write(c_kv, cdt), _cache_write(k_rope, cdt))
        # expanded form: per-head K (nope) and V from the latent, the rope
        # parts concatenated so that one attention call covers both terms
        k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["w_uk"])
        v = torch.einsum("bsr,rhd->bshd", c_kv, p["w_uv"])
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sq, H, dr)],
                      dim=-1)
        q, k, v = _constrain_qkv(q, k, v, H, cfg.attn_batch2d)
        out = sdpa(q, k, v, causal=True, scale=scale)
    else:
        raise NotImplementedError(f"attention mode {mode!r} is not ported")

    out = out.reshape(B, Sq, H * dv) @ p["wo"]
    return logical_constraint(out, "batch", "tp_seq", "embed"), new_cache


def _mla_down_placed(cfg: ModelConfig, p, x: Placed):
    """``wq_a`` and ``wkv_a`` with their norms on placed activations,
    split as the reference's compiled step splits them: on a
    sequence-parallel ``x`` (training, prefill) each rank projects its
    positions and the latents are gathered over the sequence's axes, not
    ``x`` whole (1,536 + 512 + 64 columns against D = 5,120); on a
    sequence ``x`` holds whole (decode) the contraction is cut over the
    ``tp`` axis and the partial latents summed over it in rank order.
    Returns (q_lat, c_kv, the unrotated rope key), the sequence whole."""
    kvr = cfg.kv_lora_rank
    rows = (x.spec[0], None, None)
    if x.spec[1] is None:
        _, rules = sharding.current_mesh_rules()
        tax = (rules or sharding.LogicalRules()).spec(
            ("tp",), (x.shape[-1],), x.mesh)[0]
        x = relayout(x, x.spec[:2] + (tax,))
    # a row-parallel product's sums taken; the sequence's split kept
    lat = lambda w: relayout(placed_matmul(x, p[w]), x.spec[:2] + (None,))
    q_lat = rms_norm(lat("wq_a"), p["q_norm"])
    kv = lat("wkv_a")
    c_kv = kv.map(lambda t, s: rms_norm(t[..., :kvr], s), p["kv_norm"])
    k_raw = kv.map(lambda t: t[..., kvr:])
    return (relayout(q_lat, rows), logical_constraint(c_kv, "batch", None,
                                                      None),
            relayout(k_raw, rows))


def _mla_latents_placed(cfg: ModelConfig, p, x: Placed, positions):
    """MLA's query heads and its latents on placed activations: ``q_lat``,
    ``c_kv`` and the shared rope key from :func:`_mla_down_placed`, whole
    over the sequence on every model rank; ``wq_b`` column-parallel over
    heads (its per-head blocks of dn + dr columns stay whole at every
    split that divides H), the rope parts rotated at ``positions`` (whole
    (1, S), or placed (B, S): each rank its rows').  Returns (q (B, S, H,
    dn + dr), c_kv (B, S, kvr), k_rope (B, S, dr))."""
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat, c_kv, k_raw = _mla_down_placed(cfg, p, x)
    pos = ((relayout(positions, (c_kv.spec[0], None)),)
           if is_placed(positions) else ())
    rope = lambda t, *pb: apply_rope(t, pb[0] if pb else positions,
                                     cfg.rope_theta)
    q = _split_heads(placed_matmul(q_lat, p["wq_b"]), H, dn + dr).map(
        lambda t, *pb: torch.cat([t[..., :dn], rope(t[..., dn:], *pb)],
                                 dim=-1), *pos)
    k_rope = relayout(k_raw, c_kv.spec).map(
        lambda t, *pb: rope(t[..., None, :], *pb)[:, :, 0], *pos)
    return q, c_kv, k_rope


def _mla_train_placed(cfg: ModelConfig, p, x: Placed, positions,
                      cache: bool = False):
    """MLA's expanded training (and prefill) form on placed activations:
    the sequence gathered; the query heads and latents of
    :func:`_mla_latents_placed`; each rank's heads of ``w_uk``/``w_uv``
    expanding the latent into its K and V; the rope key broadcast to the
    rank's heads; :func:`sdpa` on each rank's rows and heads; ``wo``
    row-parallel.  Returns ``(out, None)``, or with ``cache`` (prefill)
    ``(out, (c_kv, k_rope))``, whole on every model rank as
    ``cache_logical`` keeps them (packed under ``kv_cache_bits`` 8)."""
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q, c_kv, k_rope = _mla_latents_placed(cfg, p, x, positions)
    heads = q.spec[:2] + (q.spec[2], None)
    up = lambda w: c_kv.map(lambda c, wb: torch.einsum("bsr,rhd->bshd", c, wb),
                            relayout(p[w], (None, q.spec[2], None)),
                            spec=heads)
    k = up("w_uk").map(lambda kn, kr: torch.cat(
        [kn, kr[:, :, None, :].expand(*kn.shape[:3], dr)], dim=-1), k_rope)
    qc, k, v = _constrain_qkv(q, k, up("w_uv"), H, cfg.attn_batch2d)
    out = _attend_placed(qc, k, v, causal=True,
                         scale=1.0 / math.sqrt(dn + dr))
    out = _out_proj_placed(p, out)
    if not cache:
        return out, None
    cdt = torch.int8 if cfg.kv_cache_bits == 8 else c_kv.dtype
    return out, (c_kv.map(lambda t: _cache_write(t, cdt)),
                 k_rope.map(lambda t: _cache_write(t, cdt)))


def _mla_decode_placed(cfg: ModelConfig, p, x: Placed, positions, cache,
                       cache_pos):
    """MLA's absorbed decode on placed activations (B, 1, D): the query
    heads over the model axis, the new token's latents (whole on every
    model rank) written in place into each rank's block of the latent
    caches at ``cache_pos``; each rank scores its heads against its
    block's whole latent cache, takes the context in the latent space and
    up-projects it by its heads of ``w_uv``; ``wo`` row-parallel."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    cc, cr = cache
    xs = relayout(x, cc.spec[:1] + (None, None))
    q, c_kv, k_rope = _mla_latents_placed(cfg, p, xs, positions)
    row = lambda t: t.map(lambda b: _cache_write(b[:, 0], cc.dtype),
                          spec=t.spec[:1] + t.spec[2:])
    sharding.write_rows(cc, row(c_kv), cache_pos)
    sharding.write_rows(cr, row(k_rope), cache_pos)
    pos = relayout(cache_pos, cc.spec[:1])
    heads = (None, q.spec[2], None)
    w_uk, w_uv = relayout(p["w_uk"], heads), relayout(p["w_uv"], heads)
    scale = 1.0 / math.sqrt(dn + dr)
    out = []
    for i, qb in enumerate(q.blocks):
        cb, rb = cc.blocks[i], cr.blocks[i]
        q_c = torch.einsum("bthd,rhd->bthr", qb[..., :dn], w_uk.blocks[i])
        s = (torch.einsum("bthr,bsr->bhts", q_c.to(torch.float32),
                          _cache_read(cb, torch.float32))
             + torch.einsum("bthe,bse->bhts", qb[..., dn:].to(torch.float32),
                            _cache_read(rb, torch.float32))) * scale
        s = s + torch.where(_valid(pos.blocks[i], cb.shape[1]), 0.0,
                            NEG_INF)[:, None, None, :]
        probs = torch.softmax(s, dim=-1).to(qb.dtype)
        ctx = torch.einsum("bhts,bsr->bthr", probs, _cache_read(cb, qb.dtype))
        o = torch.einsum("bthr,rhd->bthd", ctx, w_uv.blocks[i])
        out.append(o.reshape(*o.shape[:2], -1))
    out = Placed(out, q.spec[:3], x.mesh)
    return _out_proj_placed(p, out), cache


def count_gqa_params(cfg: ModelConfig) -> int:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = D * H * Dh * 2 + D * KV * Dh * 2
    if cfg.attn_bias:
        n += H * Dh + 2 * KV * Dh + D
    return n


def count_mla_params(cfg: ModelConfig) -> int:
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return (D * qr + qr * H * (dn + dr) + D * (kvr + dr)
            + kvr * H * dn + kvr * H * dv + H * dv * D)
