"""Shared model substrate: param defs, norms, RoPE, activations, embeddings.

Counterpart of ``repro/models/common.py``.  Parameters are declared once as
:class:`ParamDef` (shape + per-dimension logical axes + initializer + dtype)
and materialized by :func:`init_params` into a nested dict of tensors with
the reference's keys and layouts — weights are ``(in, out)`` and applied as
``x @ w`` — so a parameter tree of the reference converts leaf by leaf
(:mod:`repro_torch.convert`).  The same declarations give the placement
specs (:func:`logical_tree`, resolved by
:func:`repro_torch.dist.sharding.tree_specs`) and shape-only stand-ins on
the ``meta`` device (:func:`abstract_params`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import sharding
from repro_torch.dist.sharding import Placed, logical_constraint, relayout


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape, per-dim logical axes, init spec."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # stddev multiplier (normal) / stddev (embed)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


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


def abstract_params(defs) -> Any:
    """Shape-and-dtype stand-ins on the ``meta`` device: nothing is
    allocated."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def logical_tree(defs) -> Any:
    """Tree of logical-axis tuples, the same structure as the params."""
    return map_defs(lambda d: d.logical, defs)


def zeros_from(struct, device) -> Any:
    """Zero tensors on ``device`` shaped like a (dict / tuple) tree of
    stand-ins, e.g. a family's ``cache_struct``."""
    if isinstance(struct, dict):
        return {k: zeros_from(v, device) for k, v in struct.items()}
    if isinstance(struct, tuple):
        return tuple(zeros_from(v, device) for v in struct)
    return torch.zeros(struct.shape, dtype=struct.dtype, device=device)


@functools.lru_cache(maxsize=None)
def kept_f32(layer_defs, cfg):
    """Tree of bools over one block's declarations ``layer_defs(cfg,
    dtype)``: the leaves declared fp32 whatever the working dtype (norms,
    the MoE router, the SSM's decay islands), which the compute cast leaves
    alone."""
    return map_defs(lambda d: d.dtype == torch.float32,
                    layer_defs(cfg, torch.bfloat16))


def compute_cast(cfg, p, layer_defs):
    """One block's master parameters ``p`` in the compute dtype, but the
    leaves :func:`kept_f32` keeps."""
    from repro_torch.core import tree as tree_lib
    dt = cfg.activation_dtype()
    return tree_lib.map_tree(lambda w, keep: w if keep else w.to(dt), p,
                             kept_f32(layer_defs, cfg))


def merge_optional(a, b):
    """``a.merge(b)`` (activation statistics), ``None`` the identity."""
    if a is None or b is None:
        return b if a is None else a
    return a.merge(b)


# ---------------------------------------------------------------------------
# Normalization / activations (fp32 islands).
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    if isinstance(x, Placed):
        return _norm_placed(rms_norm, x, scale, eps=eps)
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    if isinstance(x, Placed):
        return _norm_placed(layer_norm, x, scale, bias, eps=eps)
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def _norm_placed(norm, x: Placed, *params, eps: float) -> Placed:
    """A norm over the last dim on placed activations, rank by rank: the
    last dim gathered if it is split, the (replicated) parameters each
    rank's copy."""
    if x.spec[-1] is not None:
        x = relayout(x, x.spec[:-1] + (None,))
    return x.map(lambda t, *ps: norm(t, *ps, eps=eps), *params)


def gated_rms_norm_placed(y: Placed, z: Placed, scale: Placed,
                          eps: float = 1e-6) -> Placed:
    """``rms_norm(y * silu(z), scale)`` on placed ``y`` and ``z`` whose
    last dim may be split (a Mamba2 mixer's ``di`` over the model axis):
    each rank's sum of squares over its block, summed over the split in
    rank order, over the whole dim's size; ``z`` and ``scale`` laid out
    like ``y``."""
    g = y.map(lambda a, b: a * torch.nn.functional.silu(b),
              relayout(z, y.spec))
    scale = relayout(scale, (y.spec[-1],))
    ss = sharding.psum(y.mesh, sharding._entry_axes(y.spec[-1]), [
        (b.to(torch.float32) ** 2).sum(dim=-1, keepdim=True)
        for b in g.blocks])
    n = y.shape[-1]
    out = [(b.to(torch.float32) * torch.rsqrt(s / n + eps)
            * sc.to(torch.float32)).to(b.dtype)
           for b, s, sc in zip(g.blocks, ss, scale.blocks)]
    return Placed(out, y.spec, y.mesh, y.shape)


def add_bias(t: Placed, b: Placed) -> Placed:
    """``t + b`` for a 1-D ``b`` over ``t``'s last dim, each rank adding its
    block of ``b`` (laid out like that dim) to its block of ``t``."""
    return t.map(torch.add, relayout(b, (t.spec[-1],)))


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
    defs = {"tok": ParamDef((vp, d_model), ("vocab_out", "embed"),
                            init="embed", scale=0.02, dtype=dtype)}
    if not tie:
        defs["unembed"] = ParamDef((d_model, vp), ("embed", "vocab_out"),
                                   init="normal", dtype=dtype)
    return defs


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor,
                 seq_axis: Optional[str] = "tp_seq") -> torch.Tensor:
    if isinstance(emb, Placed):
        return embed_lookup_placed(emb, tokens, seq_axis)
    x = emb[tokens.to(torch.int64)]
    return logical_constraint(x, "batch", seq_axis, "embed")


# keys under which a caller may park an fp32 copy of a low-precision tied
# embedding table or untied unembedding table, so unembed does not cast the
# table on every call
TOK_F32 = "tok_f32"
UNEMBED_F32 = "unembed_f32"


def _table_keys(params: Dict[str, torch.Tensor]) -> Tuple[str, str]:
    """(the unembedding table's key, its held fp32 cast's key)."""
    return ("unembed", UNEMBED_F32) if "unembed" in params else ("tok", TOK_F32)


def hold_fp32_table(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` (an ``embed`` dict) with the fp32 cast of its
    unembedding table held beside it — the tied ``tok`` or the untied
    ``unembed`` — for a caller that unembeds often; ``params`` itself when
    the table is fp32 or its cast is already held."""
    src, key = _table_keys(params)
    if key in params or params[src].dtype == torch.float32:
        return params
    return dict(params, **{key: params[src].to(torch.float32)})


def unembed(x: torch.Tensor, params: Dict[str, torch.Tensor],
            vocab: int) -> torch.Tensor:
    """Project hidden states to logits (fp32); mask vocab-padding columns.

    The product runs in fp32 against the fp32 cast of the table.  A caller
    that unembeds often (the serving engine) holds that cast once
    (:func:`hold_fp32_table`); without it the table is cast per call.
    """
    src, key = _table_keys(params)
    w = params.get(key)
    if isinstance(x, Placed):
        return _unembed_placed(x, params[src] if w is None else w,
                               src == "tok", vocab)
    xf = x.to(torch.float32)
    if w is None:
        w = params[src].to(torch.float32)
    logits = xf @ (w.T if src == "tok" else w)
    if logits.shape[-1] != vocab:
        logits[..., vocab:] = -1e30
    return logical_constraint(logits, "batch", "seq", "vocab_out")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _xent_chunk(xc, lc, mc, params, vocab):
    logits = unembed(xc, params, vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum((logz - gold) * mc)


def fused_unembed_xent(x: torch.Tensor, params: Dict[str, torch.Tensor],
                       vocab: int, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       chunk: int = 512) -> torch.Tensor:
    """Unembed + cross-entropy over sequence chunks of ``chunk`` positions.

    Each chunk runs under ``torch.utils.checkpoint``, so the (B, S, V) fp32
    logits — 0.5 GB per 512 positions of a batch of 2 at a 128k vocab, and
    as much again for their gradient — never exist whole, and the backward
    recomputes one chunk's logits at a time.  Same mean loss as
    :func:`softmax_xent` of the full logits.
    """
    from torch.utils.checkpoint import checkpoint
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    labels = labels.to(torch.int64)
    nll = None
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        part = checkpoint(_xent_chunk, x[:, sl], labels[:, sl], mask[:, sl],
                          params, vocab, use_reentrant=False,
                          preserve_rng_state=False)
        nll = part if nll is None else nll + part
    return nll / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# The placed forms (a state placed over a mesh, each rank on its blocks).
# ---------------------------------------------------------------------------

def whole_but_batch(x: Placed) -> Placed:
    """``x`` with every dim but the leading (batch) one gathered: the
    input of a column-parallel product."""
    return relayout(x, (x.spec[0],) + (None,) * (x.ndim - 1))


def placed_matmul(x: Placed, w: Placed) -> Placed:
    """``x @ w`` for ``x`` (..., K) and a 2-D ``w`` (K, N), rank by rank.
    ``w``'s rows take ``x``'s split of K (gathered or sliced to it); its
    columns keep their split unless ``x`` already splits another dim over
    that axis (an FSDP split over data, where the batch is), in which case
    they are gathered.  With K split the result is a sum still to be taken
    over K's axes (``partial``): the row-parallel product."""
    xk = x.spec[-1]
    k_axes = sharding._entry_axes(xk)
    used = set(sharding.spec_axes(x.spec[:-1])) | set(k_axes) | set(x.partial)
    wn = w.spec[1]
    if set(sharding._entry_axes(wn)) & used:
        wn = None
    w = relayout(w, (xk, wn))
    return x.map(torch.matmul, w, spec=x.spec[:-1] + (wn,),
                 partial=x.partial + k_axes)


def _vocab_origin(table: Placed, i: int, dim: int) -> int:
    return table.geometry(i)[0][dim]


def _unembed_placed(x: Placed, table: Placed, transposed: bool,
                    vocab: int) -> Placed:
    """:func:`unembed` on placed hidden states (a serving step's few
    positions), vocab-parallel: the positions whole on each rank, each
    rank's fp32 logits over its block of the table's vocab columns, the
    padding columns masked; laid out (batch, None, the table's vocab
    split)."""
    x = whole_but_batch(x)
    table = relayout(table, (table.spec[0], None) if transposed
                     else (None, table.spec[1]))
    vax = table.spec[0 if transposed else 1]
    out = []
    for i, (xb, w) in enumerate(zip(x.blocks, table.blocks)):
        w = w.to(torch.float32)
        z = xb.to(torch.float32) @ (w.T if transposed else w)
        v0 = _vocab_origin(table, i, 0 if transposed else 1)
        if v0 + z.shape[-1] > vocab:
            z[..., max(vocab - v0, 0):] = -1e30
        out.append(z)
    return Placed(out, x.spec[:-1] + (vax,), x.mesh)


def placed_cache(struct, logical, like: Placed):
    """A family's decode cache (``cache_struct``'s stand-ins, under its
    ``cache_logical`` axes) as zero placed blocks on ``like``'s mesh and
    device, laid out by the bound rules (the default rules without a
    binding): what ``launch.specs.decode_shardings`` gives the cache."""
    _, rules = sharding.current_mesh_rules()
    specs = sharding.tree_specs(logical, struct, like.mesh,
                                rules or sharding.LogicalRules())
    return sharding.place_zeros(struct, specs, like.mesh, like.device)


def placed_pos(tokens: Placed, S: int) -> Placed:
    """A placed prompt's next write position, ``S`` for every row, laid
    out over ``batch`` like the tokens' rows."""
    return tokens.map(lambda t: torch.full((t.shape[0],), S, dtype=torch.int32,
                                           device=t.device),
                      spec=tokens.spec[:1])


def row_positions(pos):
    """(B,) write positions → the (B, 1) positions of a decode step's
    token (placed: each rank its rows)."""
    if isinstance(pos, Placed):
        return pos.map(lambda t: t[:, None], spec=pos.spec + (None,))
    return pos[:, None]


def last_logits(logits):
    """(B, 1, V) → (B, V) (placed: each rank its block)."""
    if isinstance(logits, Placed):
        return logits.map(lambda t: t[:, -1],
                          spec=logits.spec[:1] + logits.spec[2:])
    return logits[:, -1]


def last_position(x: Placed) -> Placed:
    """(B, S, ...) → (B, 1, ...): the last position, from the rank block
    that holds it when the sequence is split (each rank's last row
    gathered over the split, the last of them kept)."""
    rows = x.map(lambda t: t[:, -1:], spec=(x.spec[0], None) + x.spec[2:])
    axes = sharding._entry_axes(x.spec[1])
    if not axes:
        return rows
    blocks = rows.blocks
    for a in reversed(axes):
        blocks = sharding.all_gather(x.mesh, a, blocks, 1)
    return Placed([b[:, -1:] for b in blocks], rows.spec, x.mesh)


def embed_lookup_placed(emb: Placed, tokens: Placed,
                        seq_axis: Optional[str] = "tp_seq") -> Placed:
    """:func:`embed_lookup` on a placed table: vocab-parallel when the
    table's rows are split (each rank looks up the tokens in its rows,
    zeros elsewhere, and the ranks' rows are summed over the split by the
    layout's reduce-scatter or psum)."""
    emb = relayout(emb, (emb.spec[0], None))
    axes = sharding._entry_axes(emb.spec[0])
    out = []
    for i, (e, t) in enumerate(zip(emb.blocks, tokens.blocks)):
        t = t.to(torch.int64)
        if not axes:
            out.append(e[t])
            continue
        local = t - _vocab_origin(emb, i, 0)
        inb = (local >= 0) & (local < e.shape[0])
        out.append(e[local.clamp(0, e.shape[0] - 1)] * inb[..., None].to(e.dtype))
    x = Placed(out, tokens.spec + (None,), tokens.mesh, partial=axes)
    return logical_constraint(x, "batch", seq_axis, "embed")


def placed_lm_loss(cfg, forward, *inputs: str):
    """A family's ``placed_loss_fn``: ``(params, batch, qctx) -> (loss,
    aux)`` on a placed state and batch, ``forward(cfg, params, tokens,
    *batch[inputs], qctx) -> (final hidden, act_stats)`` the family's
    training forward on the tokens but the last, the loss
    :func:`fused_unembed_xent_placed` of the next tokens (a placed scalar,
    the global mean on every rank)."""

    def fn(params, batch, qctx=None):
        tokens = batch["tokens"]
        hidden, stats = forward(cfg, params, tokens.map(lambda t: t[:, :-1]),
                                *(batch[k] for k in inputs), qctx)
        loss = fused_unembed_xent_placed(hidden, params["embed"], cfg.vocab,
                                         tokens.map(lambda t: t[:, 1:]),
                                         batch.get("loss_mask"))
        return loss, {"act_stats": stats}

    return fn


def _xent_chunk_placed(xc: Placed, lc: Placed, mc: Placed, table: Placed,
                       transposed: bool, vocab: int) -> Placed:
    """One chunk of :func:`fused_unembed_xent_placed`: each rank's logits
    over its vocab columns; the logsumexp's max and sum, and the target
    logit, taken over the vocab split.  Returns the summed masked NLL, a
    placed scalar."""
    axes = sharding._entry_axes(table.spec[0 if transposed else 1])
    mesh = xc.mesh
    logits, gold = [], []
    for i, (x, w, lab) in enumerate(zip(xc.blocks, table.blocks, lc.blocks)):
        w = w.to(torch.float32)
        z = x.to(torch.float32) @ (w.T if transposed else w)
        v0 = _vocab_origin(table, i, 0 if transposed else 1)
        if v0 + z.shape[-1] > vocab:
            z[..., max(vocab - v0, 0):] = -1e30
        local = lab - v0
        inb = (local >= 0) & (local < z.shape[-1])
        g = torch.gather(z, -1, local.clamp(0, z.shape[-1] - 1)[..., None])
        logits.append(z)
        gold.append(g[..., 0] * inb.to(z.dtype))
    m = sharding.pmax(mesh, axes, [z.detach().amax(-1) for z in logits])
    se = sharding.psum(mesh, axes, [torch.exp(z - mi[..., None]).sum(-1)
                                    for z, mi in zip(logits, m)])
    gold = sharding.psum(mesh, axes, gold)
    return Placed([torch.sum((mi + torch.log(s) - g) * mk)
                   for mi, s, g, mk in zip(m, se, gold, mc.blocks)],
                  (), mesh)


def fused_unembed_xent_placed(x: Placed, params, vocab: int, labels: Placed,
                              mask: Optional[Placed] = None,
                              chunk: int = 512) -> Placed:
    """:func:`fused_unembed_xent` on placed hidden states (B, S, D) and a
    placed table: the sequence gathered, then chunk by chunk under
    ``torch.utils.checkpoint`` the vocab-parallel cross-entropy of
    :func:`_xent_chunk_placed`; the NLL and the mask summed over the batch
    split.  Returns the global mean loss, a placed scalar (every rank
    the same value)."""
    from torch.utils.checkpoint import checkpoint
    src, _ = _table_keys(params)
    table = params[src]
    transposed = src == "tok"
    x = whole_but_batch(x)
    labels = labels.map(lambda t: t.to(torch.int64))
    if mask is None:
        mask = labels.map(lambda t: torch.ones(t.shape, dtype=torch.float32,
                                               device=t.device))
    mask = mask.map(lambda t: t.to(torch.float32))
    S = x.shape[1]
    nll = None
    for s0 in range(0, S, chunk):
        cut = lambda p: p.map(lambda t: t[:, s0:s0 + chunk])
        part = checkpoint(_xent_chunk_placed, cut(x), cut(labels), cut(mask),
                          table, transposed, vocab, use_reentrant=False,
                          preserve_rng_state=False)
        nll = part if nll is None else nll.map(torch.add, part)
    batch_axes = sharding._entry_axes(x.spec[0])
    total = sharding.psum(x.mesh, batch_axes, nll.blocks)
    with torch.no_grad():
        count = sharding.psum(x.mesh, batch_axes,
                              [torch.sum(m) for m in mask.blocks])
    return Placed([t / torch.clamp(c, min=1.0) for t, c in zip(total, count)],
                  (), x.mesh)
