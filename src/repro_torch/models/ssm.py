"""Mamba2 (SSD — state-space duality) block, chunked-scan formulation.

Counterpart of ``repro/models/ssm.py``.  The SSD algorithm of Dao & Gu '24
(arXiv:2405.21060): the sequence is split into chunks of ``ssm_chunk``;
within a chunk the output is a masked, decay-weighted attention-like
product, across chunks a small recurrence carries the (H, P, N) state.
Train and prefill cost O(S·Q·(P+N)); decode is an O(1) state update.

Numerics: the recurrent state, per-step decays, ``a_log`` and ``dt_bias``
stay fp32 (the policy's carve-out: a fixed-point state underflows at 2^-FL
over long recurrences).

One difference from the reference, on purpose: :func:`ssd_scan` fills the
upper triangle of the intra-chunk log-decays with ``-inf`` before the
``exp``.  The reference takes ``exp(rel) * tril``, and above the diagonal
``rel`` is a sum of positive terms: at the configs' chunk of 256 with their
initialization (``a_log = dt_bias = 0``) it passes fp32's range, and
``inf · 0`` is NaN.  Where the reference is finite the two agree bit for
bit (``exp(x) · 1 = exp(x)``, ``exp(-inf) = 0``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (LogicalRules, Placed,
                                       current_mesh_rules, is_placed,
                                       logical_constraint, relayout)
from repro_torch.models.common import (ParamDef, gated_rms_norm_placed,
                                       placed_matmul, rms_norm,
                                       whole_but_batch)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_channels(cfg: ModelConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state


def ssm_defs(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, ParamDef]:
    D, N = cfg.d_model, cfg.ssm_state
    di, H = d_inner(cfg), n_ssm_heads(cfg)
    cc = conv_channels(cfg)
    return {
        # in_proj emits [z, x, B, C, dt]
        "w_in": ParamDef((D, 2 * di + 2 * N + H), ("fsdp", "tp"),
                         dtype=dtype),
        "conv_w": ParamDef((cfg.ssm_conv, cc), (None, "tp"), scale=1.0,
                           dtype=dtype),
        "conv_b": ParamDef((cc,), ("tp",), init="zeros", dtype=dtype),
        "a_log": ParamDef((H,), (None,), init="zeros"),
        "dt_bias": ParamDef((H,), (None,), init="zeros"),
        "d_skip": ParamDef((H,), (None,), init="ones"),
        "norm_scale": ParamDef((di,), ("tp",), init="ones"),
        "w_out": ParamDef((di, D), ("tp", "fsdp"), dtype=dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, N = d_inner(cfg), cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq.  xbc (B,S,C), w (K,C).

    With ``state`` (B, K-1, C) — decode path — prepends the cached tail.
    Returns ``(silu(out), new tail (B, K-1, C))``."""
    K, S = w.shape[0], xbc.shape[1]
    if state is not None:
        full = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    else:
        full = F.pad(xbc, (0, 0, K - 1, 0))
    windows = torch.stack([full[:, i:i + S] for i in range(K)], 0)
    out = torch.einsum("kbsc,kc->bsc", windows, w) + b
    new_state = full[:, full.shape[1] - (K - 1):] if K > 1 else None
    return F.silu(out), new_state


def _decays(cfg: ModelConfig, dt_raw: torch.Tensor, a_log: torch.Tensor,
            dt_bias: torch.Tensor):
    """Per-(step, head) dt and log-decay, fp32.  dt_raw (..., H)."""
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias)
    a = -torch.exp(a_log.to(torch.float32))
    return dt, dt * a                       # log_decay <= 0


def chunk_cb(cfg: ModelConfig, b_mat: torch.Tensor, c_mat: torch.Tensor
             ) -> torch.Tensor:
    """C·Bᵀ of each chunk, (B, nc, Q, Q) fp32, of b, c (B, S, n) padded
    to the chunk grid: :func:`ssd_scan`'s intra-chunk scores, or (``n`` a
    block of the state) their addends."""
    B, S, n = b_mat.shape
    Q = min(cfg.ssm_chunk, S)
    pad = -S % Q
    cut = lambda t: F.pad(t, (0, 0, 0, pad)).reshape(
        B, -1, Q, n).to(torch.float32)
    return torch.einsum("bcqn,bckn->bcqk", cut(c_mat), cut(b_mat))


def ssd_scan(cfg: ModelConfig, x: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, dt: torch.Tensor, log_decay: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             cb: Optional[torch.Tensor] = None):
    """Chunked SSD.  x (B,S,H,P); b,c (B,S,N); dt/log_decay (B,S,H) fp32;
    ``cb``: the chunks' C·Bᵀ when the caller has it (:func:`chunk_cb`).

    Returns (y (B,S,H,P), h_final (B,H,P,N) fp32)."""
    B, S, H, Pd = x.shape
    N = b_mat.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    if cb is None:
        cb = chunk_cb(cfg, b_mat, c_mat)
    if S % Q:
        # pad to the chunk grid: zero x/B/C (no state contribution) and zero
        # log_decay (decay factor 1 — final state unaffected)
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    f32 = torch.float32

    xr = (x * dt[..., None].to(x.dtype)).reshape(B, nc, Q, H, Pd).to(f32)
    br = b_mat.reshape(B, nc, Q, N).to(f32)
    cr = c_mat.reshape(B, nc, Q, N).to(f32)
    # heads on the model axis (B/C are head-shared and stay replicated)
    xr = logical_constraint(xr, "batch", None, None, "heads", None)
    ld = logical_constraint(log_decay.reshape(B, nc, Q, H),
                            "batch", None, None, "heads")
    cum = torch.cumsum(ld, dim=2)                               # (B,nc,Q,H)
    total = cum[:, :, -1]                                       # (B,nc,H)

    # --- intra-chunk (quadratic in Q only; the module's memory hot spot) ---
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,nc,Q,Q,H) t-s
    # the exponent is masked, not its result: above the diagonal rel > 0 can
    # overflow, and where(tri, exp(rel), 0)'s backward would bring the
    # inf · 0 back
    above = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    decay_m = torch.exp(rel.masked_fill(above[None, None, :, :, None],
                                        float("-inf")))
    m = cb[..., None] * decay_m                                  # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xr)

    # --- chunk states ---
    w_state = torch.exp(total[:, :, None, :] - cum)              # (B,nc,Q,H)
    s_chunk = torch.einsum("bckn,bckh,bckhp->bchpn", br, w_state, xr)

    # --- inter-chunk recurrence: the state before each chunk ---
    h = (torch.zeros((B, H, Pd, N), dtype=f32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cr, torch.exp(cum),
                           h_prevs)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)[:, :S_orig]
    return y.to(x.dtype), h


def ssm_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              *, mode: str = "train",
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Mamba2 mixer.  cache = (ssm_state (B,H,P,N) fp32, conv_tail
    (B,K-1,C)): the decode step reads it; prefill may start from it.

    Returns (out (B,S,D), new_cache): ``(state, tail)`` in prefill and
    decode, ``None`` in train."""
    if is_placed(x):
        if mode == "decode":
            return _ssm_decode_placed(cfg, p, x, cache)
        return _ssm_train_placed(cfg, p, x, cache_out=mode == "prefill")
    B, S, _ = x.shape
    di, N, H, Pd = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg), cfg.ssm_head_dim

    zxbcdt = x @ p["w_in"]
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    zxbcdt = logical_constraint(zxbcdt, "batch", "seq", "tp")

    conv_state = cache[1] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xi = xbc[..., :di].reshape(B, S, H, Pd)
    b_mat = xbc[..., di:di + N]
    c_mat = xbc[..., di + N:]

    dt, log_decay = _decays(cfg, dt_raw, p["a_log"], p["dt_bias"])

    if mode == "decode":
        # O(1) recurrence: h = exp(dt·A)·h + dt·B⊗x  (S == 1)
        h = cache[0]
        a = torch.exp(log_decay[:, 0])                           # (B,H)
        xu = xi[:, 0].to(torch.float32) * dt[:, 0][..., None]
        h_new = (a[..., None, None] * h
                 + torch.einsum("bhp,bn->bhpn", xu,
                                b_mat[:, 0].to(torch.float32)))
        y = torch.einsum("bn,bhpn->bhp", c_mat[:, 0].to(torch.float32), h_new)
        y = y[:, None].to(x.dtype)                               # (B,1,H,P)
        new_cache = (h_new, new_conv)
    else:
        h0 = cache[0] if cache is not None else None
        y, h_final = ssd_scan(cfg, xi, b_mat, c_mat, dt, log_decay, h0)
        new_cache = (h_final, new_conv) if mode == "prefill" else None

    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xi
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    return logical_constraint(y @ p["w_out"], "batch", "seq", "embed"), \
        new_cache


def _piece(t: Placed, lo: int, hi: int, ax) -> Placed:
    """Columns ``[lo, hi)`` of ``t`` (whole in its last dim), laid out over
    ``ax``."""
    cut = t.map(lambda b: b[..., lo:hi], spec=t.spec[:-1] + (None,))
    return relayout(cut, t.spec[:-1] + (ax,))


def _ssm_out_placed(cfg: ModelConfig, p, y: Placed, z: Placed) -> Placed:
    """The gated norm (its squares summed over the head split) and
    ``w_out`` row-parallel, its sums reduce-scattered onto the block's
    sequence-parallel residual layout."""
    y = gated_rms_norm_placed(y, z, p["norm_scale"])
    return logical_constraint(placed_matmul(y, p["w_out"]), "batch", "tp_seq",
                              "embed")


def _ssm_train_placed(cfg: ModelConfig, p, x: Placed,
                      cache_out: bool = False):
    """:func:`ssm_apply`'s train path on placed activations, each rank on
    its heads.  ``w_in``'s column blocks do not fall on the z | x | B | C |
    dt boundaries (nor ``conv_w``'s on x | B | C), so the column-parallel
    projection is gathered over its split and each piece re-cut by its own
    layout: z, x and dt by heads (when the model axis divides them), B and
    C by the state N (when it divides N), as the reference's compiled
    step splits them.  The depthwise conv runs on each rank's channels
    with its columns of ``conv_w``/``conv_b`` (no collective: channels are
    independent); each rank's block of the state gives its addend of the
    chunks' C·Bᵀ, summed over the split in rank order, and B and C are
    gathered over it (every head reads them); the chunked scan runs on
    each rank's heads, the gated norm sums its squares over the head split,
    and ``w_out`` is row-parallel, its sums reduce-scattered onto the
    block's sequence-parallel residual layout.

    Returns ``(out, None)``, or with ``cache_out`` (prefill) ``(out,
    (state, tail))``: each rank's heads of the final state (B, H, P, N)
    fp32, and the conv tail (B, K-1, C), the projection's last K-1
    positions (whole on every model rank: the cache write cuts each
    rank's channel block from it)."""
    di, N, H, Pd = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg), cfg.ssm_head_dim
    _, rules = current_mesh_rules()
    hax = (rules or LogicalRules()).spec(("heads",), (H,), x.mesh)[0]
    nax = (rules or LogicalRules()).spec(("tp",), (N,), x.mesh)[0]
    xs = whole_but_batch(x)
    whole = (xs.spec[0], None, None)
    zxbcdt = relayout(placed_matmul(xs, p["w_in"]), whole)
    z = _piece(zxbcdt, 0, di, hax)
    conv_w = relayout(p["conv_w"], (None, None))
    conv_b = relayout(p["conv_b"], (None,))

    def conv(lo: int, hi: int, ax) -> Placed:
        return _piece(zxbcdt, di + lo, di + hi, ax).map(
            lambda t, w, b: _causal_conv(t, w, b)[0],
            _piece(conv_w, lo, hi, ax), _piece(conv_b, lo, hi, ax))

    xi = conv(0, di, hax).map(lambda t: t.reshape(*t.shape[:2], -1, Pd),
                              spec=whole[:2] + (hax, None))
    b_mat, c_mat = conv(di, di + N, nax), conv(di + N, di + 2 * N, nax)
    cb = relayout(b_mat.map(lambda b, c: chunk_cb(cfg, b, c), c_mat,
                            spec=(whole[0], None, None, None),
                            partial=sharding._entry_axes(nax)),
                  (whole[0], None, None, None))
    dt_raw = _piece(zxbcdt, 2 * di + 2 * N, 2 * di + 2 * N + H, hax)
    heads = lambda name: relayout(p[name], (hax,))

    def scan(xb, bb, cm, cbb, dtb, a_log, dt_bias, d_skip):
        dt, log_decay = _decays(cfg, dtb, a_log, dt_bias)
        y, h = ssd_scan(cfg, xb, bb, cm, dt, log_decay, cb=cbb)
        y = y + d_skip.to(y.dtype)[None, None, :, None] * xb
        return y.reshape(*y.shape[:2], -1), h

    y, h = xi.map_many(scan, relayout(b_mat, whole), relayout(c_mat, whole),
                       cb, dt_raw, heads("a_log"), heads("dt_bias"),
                       heads("d_skip"),
                       specs=(whole[:2] + (hax,), (whole[0], hax, None, None)))
    out = _ssm_out_placed(cfg, p, y, z)
    if not cache_out:
        return out, None
    K = cfg.ssm_conv
    tail = _piece(zxbcdt, di, 2 * di + 2 * N, None).map(
        lambda t: F.pad(t, (0, 0, K - 1, 0))[:, -(K - 1):])
    return out, (h, tail)


def _ssm_decode_placed(cfg: ModelConfig, p, x: Placed, cache):
    """The O(1) decode step on placed activations (B, 1, D), written in
    place into each rank's block of the cache ``(state (B, H, P, N) over
    heads, tail (B, K-1, C) over tp)``: ``w_in`` column-parallel and
    gathered; the depthwise conv on each rank's channel block of the tail
    (its columns of ``conv_w``/``conv_b``), its output gathered over the
    channels and re-cut as in training (x and dt by heads, B and C whole);
    the recurrence on each rank's heads of the state; the gated norm and
    ``w_out`` as in training."""
    di, N, H, Pd = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg), cfg.ssm_head_dim
    state, tail = cache
    hax = state.spec[1]
    xs = relayout(x, state.spec[:1] + (None, None))
    whole = (xs.spec[0], None, None)
    zxbcdt = relayout(placed_matmul(xs, p["w_in"]), whole)
    z = _piece(zxbcdt, 0, di, hax)
    cax = tail.spec[2]
    xbc = _piece(zxbcdt, di, 2 * di + 2 * N, cax)
    conv_out, new_tail = xbc.map_many(
        lambda t, w, b, st: _causal_conv(t, w, b, st), relayout(
            p["conv_w"], (None, cax)), relayout(p["conv_b"], (cax,)), tail,
        specs=(xbc.spec, tail.spec))
    with torch.no_grad():
        for i, blk in tail.distinct():
            blk.copy_(new_tail.blocks[i])
    conv_out = relayout(conv_out, whole)
    xi = _piece(conv_out, 0, di, hax).map(
        lambda t: t.reshape(t.shape[0], -1, Pd), spec=(whole[0], hax, None))
    bc = _piece(conv_out, di, di + 2 * N, None)
    dt_raw = _piece(zxbcdt, 2 * di + 2 * N, 2 * di + 2 * N + H, hax)
    heads = lambda name: relayout(p[name], (hax,))

    def step(xb, bcb, dtb, hb, a_log, dt_bias, d_skip):
        dt, log_decay = _decays(cfg, dtb[:, 0], a_log, dt_bias)     # (B, H)
        xu = xb.to(torch.float32) * dt[..., None]
        h_new = (torch.exp(log_decay)[..., None, None] * hb
                 + torch.einsum("bhp,bn->bhpn", xu,
                                bcb[:, 0, :N].to(torch.float32)))
        y = torch.einsum("bn,bhpn->bhp", bcb[:, 0, N:].to(torch.float32),
                         h_new).to(x.dtype)
        y = y + d_skip.to(y.dtype)[None, :, None] * xb
        return y.reshape(y.shape[0], 1, -1), h_new

    y, h_new = xi.map_many(step, bc, dt_raw, state, heads("a_log"),
                           heads("dt_bias"), heads("d_skip"),
                           specs=(whole[:2] + (hax,), state.spec))
    with torch.no_grad():
        for i, blk in state.distinct():
            blk.copy_(h_new.blocks[i])
    return _ssm_out_placed(cfg, p, y, z), cache


def count_ssm_params(cfg: ModelConfig) -> int:
    D, N = cfg.d_model, cfg.ssm_state
    di, H = d_inner(cfg), n_ssm_heads(cfg)
    cc = conv_channels(cfg)
    return (D * (2 * di + 2 * N + H) + cfg.ssm_conv * cc + cc
            + 3 * H + di + di * D)
