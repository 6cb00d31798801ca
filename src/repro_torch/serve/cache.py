"""Paged int8 KV pool + page codec under the ``kv_cache`` precision domain.

Counterpart of ``repro/serve/cache.py``.  One page = one ⟨IL, FL⟩ group.
The ``kv_cache`` domain gets a per-group flexpoint controller with
``2 · n_layers · n_pages_total`` rows — one row per (kind ∈ {K, V}, layer,
physical page), laid out by :func:`repro_torch.serve.page_table.page_rows` —
and the page encode is the grouped wire codec: the Hopper kernel behind
``ops.dps_quantize_wire_grouped`` on the card, ``fixed_point.wire_quantize``
with a ``[G]``-leading format as its plain twin.  The kernel takes any page
size.

Format placement is **content-driven and history-free**: when a prompt is
encoded into freshly allocated pages, each written row's format comes from
one controller update over a *fresh-init* state fed that page's measured
stats (max|x| et al.), and rows reset to init when their page is freed.  A
page's ⟨IL, FL⟩ is therefore a pure function of its content — which is what
makes continuous batching safe: a request's decode trajectory cannot depend
on which physical pages it got or on its neighbours in the batch.  Pages
allocated for *generated* tokens keep the init format (⟨il_init, 8 −
il_init⟩) for their lifetime.

The pools are updated **in place**.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixed_point as fxp
from repro_torch.core import tagging
from repro_torch.core.dps import DomainSpec, PrecisionPlan, wire_hyper
from repro_torch.core.fixed_point import FixedPointFormat, QuantStats
from repro_torch.kernels import ops
from repro_torch.serve.page_table import PagedLayout

KV_DOMAIN = "kv_cache"
WIRE_BITS = 8
# init (and generated-page) format: ⟨2, 6⟩ — range ±2, step 1/64
DEFAULT_IL_INIT = 2


class PagedKV(NamedTuple):
    """The page pools, stacked over layers: ``(n_layers, n_pages_total,
    page_size, KV, Dh)`` each, int8 grid integers at ``bits=8``, fp32 at
    ``bits=None``."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor


def n_rows(cfg: ModelConfig, layout: PagedLayout) -> int:
    return 2 * cfg.n_layers * layout.n_pages_total


def kv_plan(cfg: ModelConfig, layout: PagedLayout,
            il_init: int = DEFAULT_IL_INIT) -> PrecisionPlan:
    """The serving precision plan: one wire domain, one row per page view.

    ``slack=0.0``: the radix covers exactly the measured page max — at 8
    bits the KV grid is too narrow for headroom, and the page content is
    already known when the format is placed (encode happens after
    measurement), so only the exact max element can clip (by one step).
    """
    return PrecisionPlan.of(**{KV_DOMAIN: DomainSpec(
        "flexpoint", wire_hyper(WIRE_BITS, il_init, slack=0.0),
        groups=n_rows(cfg, layout), wire=True)})


def init_pool(cfg: ModelConfig, layout: PagedLayout, bits, device) -> PagedKV:
    dt = torch.int8 if bits == 8 else torch.float32
    shp = (cfg.n_layers, layout.n_pages_total, layout.page_size,
           cfg.n_kv_heads, cfg.head_dim)
    return PagedKV(torch.zeros(shp, dtype=dt, device=device),
                   torch.zeros(shp, dtype=dt, device=device))


def fmt_tables(state, cfg: ModelConfig,
               layout: PagedLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Controller rows → the decode step's per-layer (n_pages_total, 2)
    [IL, FL] tables for K and V (leading L for the layer loop)."""
    L, n_tot = cfg.n_layers, layout.n_pages_total
    il = state.il.reshape(2, L, n_tot)
    fl = state.fl.reshape(2, L, n_tot)
    k_fmt = torch.stack([il[0], fl[0]], dim=-1).to(torch.int32)
    v_fmt = torch.stack([il[1], fl[1]], dim=-1).to(torch.int32)
    return k_fmt, v_fmt


def zero_fmt_tables(cfg: ModelConfig, layout: PagedLayout,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bits=None`` tables: FL = 0 decodes fp32 pool values by ×1.0 exactly."""
    z = torch.zeros((cfg.n_layers, layout.n_pages_total, 2),
                    dtype=torch.int32, device=device)
    return z, z


def encode_pages(xg: torch.Tensor, fmt: FixedPointFormat,
                 mask: Optional[torch.Tensor], *, backend: str,
                 quantum: int) -> torch.Tensor:
    """The page codec: (G_w, page_elems) fp32 → int8 grid integers.

    ``backend="kernel"`` launches the grouped wire kernel (one tile per
    page); ``"plain"`` is its bit-equal twin (``wire_quantize`` with a
    [G]-leading format); ``"auto"`` takes the kernel for a CUDA tensor and
    the twin for a CPU tensor.  ``mask`` zeroes padding out of the wire, or
    ``None`` where the padding is zero already.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown page-encode backend {backend!r}")
    if backend == "auto":
        backend = "kernel" if xg.is_cuda else "plain"
    if backend == "kernel":
        tg = torch.arange(xg.shape[0], dtype=torch.int32, device=xg.device)
        wire, _ = ops.dps_quantize_wire_grouped(
            xg.reshape(-1), fmt, tg,
            mask=None if mask is None else mask.reshape(-1), stochastic=False, quantum=quantum, compute_stats=False,
            backend="kernel")
        return wire.reshape(xg.shape)
    wire, _ = fxp.wire_quantize(xg, fmt, mode=fxp.ROUND_NEAREST,
                                mask=mask, compute_stats=False)
    return wire


def _page_stats(xg: torch.Tensor, mask: torch.Tensor) -> QuantStats:
    """Pre-encode per-page stats the flexpoint placement consumes."""
    absx = xg.abs() * mask
    z = torch.zeros(xg.shape[:1], dtype=torch.float32, device=xg.device)
    return QuantStats(
        count=mask.sum(dim=1),
        nonzero=(absx > 0.0).to(torch.float32).sum(dim=1),
        overflow=z, abs_err_sum=z, rel_err_sum=z,
        abs_sum=absx.sum(dim=1),
        max_abs=absx.amax(dim=1))


def _row_index(cfg: ModelConfig, layout: PagedLayout,
               phys: torch.Tensor) -> torch.Tensor:
    """(2, L, len(phys)) → flat (G_w,) domain rows (page_rows on tensors)."""
    L, n_tot = cfg.n_layers, layout.n_pages_total
    kinds = torch.arange(2, device=phys.device)[:, None, None]
    layers = torch.arange(L, device=phys.device)[None, :, None]
    return ((kinds * L + layers) * n_tot
            + phys[None, None, :].to(torch.int64)).reshape(-1)


def _select(mask: torch.Tensor, new, old):
    """Field-wise ``where(mask, new, old)`` over a controller state."""
    return type(old)(*(torch.where(mask, getattr(new, f.name),
                                   getattr(old, f.name))
                       for f in dataclasses.fields(old)))


def write_prompt_pages(cfg: ModelConfig, layout: PagedLayout, plan,
                       pools: PagedKV, state, ck: torch.Tensor,
                       cv: torch.Tensor, phys: torch.Tensor, plen: int, *,
                       bits, encode_backend: str):
    """Encode one prefilled (B=1) contiguous cache into its pages.

    ``ck``/``cv``: (L, 1, max_prompt, KV, Dh) from the prefill forward.
    ``phys``: (prompt_pages,) physical destinations for logical page slots
    0..prompt_pages-1 — entries past the request's allocation point at the
    trash page and carry no valid tokens, so ``phys`` holds duplicates and
    the trash page's content after the scatter is unspecified.  ``plen``:
    prompt length.

    Per written page (any page with a token < ``plen``): measure stats →
    one fresh-init controller update → merge ONLY the written rows into
    ``state`` → encode on the placed grid → scatter int8 wire into the
    pools.  Pages without valid tokens (trash entries, generation-region
    pages) contribute zero stats and keep their existing rows.

    The encoder input is the whole ``(2·L·prompt_pages, page_elems)`` fp32
    buffer, already zeroed past ``plen``.  The reference passes an equally
    large fp32 mask beside it; rounding to nearest without statistics, a
    zeroed element (``+0.0`` or ``-0.0``) encodes to the byte 0 with the
    mask or without it, so the port leaves it out (4 of the 9 bytes an
    element the encoder would read).

    Returns ``(pools, state')``: the pools are written in place; ``state``
    passes through at ``bits=None``.
    """
    L, ps = cfg.n_layers, layout.page_size
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    Pp = layout.prompt_pages
    E = ps * KV * Dh
    S = layout.max_prompt
    dev = ck.device
    phys = phys.to(torch.int64)

    x = torch.stack([ck[:, 0], cv[:, 0]])                # (2, L, S, KV, Dh)
    tmask = (torch.arange(S, device=dev) < plen).to(torch.float32)
    x = x.to(torch.float32) * tmask[None, None, :, None, None]
    xg = x.reshape(2 * L * Pp, E)                        # (G_w, E)
    mg = tmask.reshape(Pp, ps, 1).expand(Pp, ps, KV * Dh).reshape(Pp, E)
    mg = mg[None, None].expand(2, L, Pp, E).reshape(2 * L * Pp, E)

    if bits is None:
        w = tagging.tag(xg.reshape(2, L, Pp, ps, KV, Dh), "kv_page",
                        domain=KV_DOMAIN, stage="write", bits=0)
        pools.k_pages[:, phys] = w[0].to(pools.k_pages.dtype)
        pools.v_pages[:, phys] = w[1].to(pools.v_pages.dtype)
        return pools, state

    rows = _row_index(cfg, layout, phys)                 # (G_w,) duplicates
    G_tot = n_rows(cfg, layout)

    def zeros():
        return torch.zeros(G_tot, dtype=torch.float32, device=dev)

    st = _page_stats(xg, mg)
    z = zeros()
    stream = QuantStats(
        count=zeros().index_add_(0, rows, st.count),
        nonzero=zeros().index_add_(0, rows, st.nonzero),
        overflow=z, abs_err_sum=z, rel_err_sum=z,
        abs_sum=zeros().index_add_(0, rows, st.abs_sum),
        max_abs=zeros().scatter_reduce_(0, rows, st.max_abs, "amax"))
    tagging.tag_tree(stream, "stats_sink", domain=KV_DOMAIN, wire=True,
                     stream=KV_DOMAIN)

    ctrl = plan.spec(KV_DOMAIN).make()
    placed = ctrl.update(ctrl.init((G_tot,), dev), stream)
    # a page is written iff it covers a token < plen (static per slot j)
    live = (torch.arange(Pp, device=dev) * ps < plen).to(torch.float32)
    written = zeros().scatter_reduce_(
        0, rows, live[None, None].expand(2, L, Pp).reshape(-1), "amax") > 0.0
    state = _select(written, placed, state)

    fmt = FixedPointFormat(state.il[rows], state.fl[rows])
    tagging.tag(xg, "encode_in", domain=KV_DOMAIN)
    wire = tagging.tag(encode_pages(xg, fmt, None, backend=encode_backend,
                                    quantum=E),
                       "kv_page", domain=KV_DOMAIN, stage="write",
                       bits=WIRE_BITS)
    w = wire.reshape(2, L, Pp, ps, KV, Dh)
    pools.k_pages[:, phys] = w[0]
    pools.v_pages[:, phys] = w[1]
    return pools, state


def reset_rows(plan, state, row_mask: torch.Tensor):
    """Reset masked controller rows to init (page freed → history cleared)."""
    ctrl = plan.spec(KV_DOMAIN).make()
    fresh = ctrl.init(tuple(row_mask.shape), row_mask.device)
    return _select(row_mask, fresh, state)
