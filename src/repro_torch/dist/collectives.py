"""Compressed collectives: the paper's quantizer on the gradient wire.

Counterpart of ``repro/dist/collectives.py``.  A fixed-point format
⟨IL, FL⟩ with IL + FL ≤ 8 puts every grid integer in [-128, 127], so a
quantized payload travels as **int8** instead of fp32 — 4× fewer bytes on
the wire for the two legs of an all-reduce.  The :class:`QuantStats` of the
dispatch leg fall out of the encode and feed the wire domain's controller.

The codec runs on the kernels of :mod:`repro_torch.kernels`: K2 (the wire
quantizer) encodes a tensor or a gradient leaf, K3 the group-aligned layout,
K4 decodes and means the receive leg; on CPU tensors their plain versions
run.  ``backend``: ``"auto"`` (the kernels for CUDA tensors), ``"kernel"`` or
``"plain"``.

Formats may be **per-group**: an ⟨IL, FL⟩ of shape ``[G]`` splits the
flattened tensor into G contiguous groups (equal ``ceil(size / G)`` chunks,
or explicit ``group_sizes``) and returns ``[G]``-shaped stats.  The
collectives run ``[G]`` formats through both legs in the **group-aligned
layout** (:class:`GroupLayout`): every group zero-padded to a multiple of the
tile ``quantum``, the buffer padded to tile-aligned rank chunks.

The collectives take a *transport* (:mod:`repro_torch.dist.transport`) in
place of the reference's ``shard_map`` axis name, per-rank inputs as one
entry per rank the transport holds, and a 64-bit ``seed`` in place of a JAX
key.  Stochastic rounding takes its bits from one of the quantizer's two
sources (``onchip_prng``): a Philox stream drawn in the kernel (K2b, K3b;
:func:`~repro_torch.kernels.dps_quant.philox_bits` in the plain versions),
or 32 bits per element drawn by ``torch.randint`` and handed to the kernel
as an operand (K2, K3; :func:`~repro_torch.kernels.ops.operand_bits`), the
reference's default.  The stream of a seed is drawn over a whole leaf or
group:

* dispatch leg: rank ``r``'s leaf (or group) ``g`` takes the stream of
  ``fold_seed(fold_seed(seed, r), g)``, element by element;
* gather leg: leaf (or group) ``g`` takes the stream of
  ``fold_seed(fold_seed(seed, LEG2), g)`` at the element's index in the leaf
  — the same on every rank, and independent of the rank chunks and the
  quantum, so the mean is the same whatever the layout.

The precision-flow verifier's landmarks (:mod:`repro_torch.core.tagging`)
sit where the reference's do: ``encode_in`` and ``sr_bits`` at every encode,
``wire_payload`` on every int8 buffer just before its collective,
``decode_out`` on every decode, ``wire_stats`` on the legs' statistics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tagging
from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import (FixedPointFormat, QuantStats,
                                          ROUND_NEAREST, ROUND_STOCHASTIC,
                                          exp2_int, fold_seed, merge_stats,
                                          wire_quantize)
from repro_torch.kernels import ops
from repro_torch.kernels.dps_quant import GroupPhilox, Philox, philox_bits

# int8 wire capacity: IL + FL beyond this saturates grid integers.
WIRE_BITS = 8

# The largest grouped-encode tile: the group-aligned layout pads every group
# to a multiple of the tile (and rank chunks to tile multiples), so a tile
# never straddles groups.  The kernels take any quantum; this one keeps K3's
# blocks large.
WIRE_GROUP_QUANTUM = 4096

# Rank chunks of a global-format payload, and grouped tiles, are rounded up
# to this many elements, so every owner's rows start on a 16-byte boundary
# (K4 reads 16 int8 a row at a time).
WIRE_CHUNK_ALIGN = 16

# The gather leg's stream salt ("LEG2"): rank-invariant, distinct from every
# dispatch-leg fold.
LEG2 = 0x4C454732


def default_wire_quantum(size: int, groups: int) -> int:
    """Size-aware grouped-wire quantum: ``ceil(size / G)`` rounded up to
    :data:`WIRE_CHUNK_ALIGN`, capped at :data:`WIRE_GROUP_QUANTUM`.  A
    full-size model resolves 4096; a tiny one a finer tile with less
    per-group padding.  The mean does not depend on the quantum."""
    a = WIRE_CHUNK_ALIGN
    target = -(-max(size, 1) // max(groups, 1))
    return min(WIRE_GROUP_QUANTUM, a * -(-target // a))


def _resolve_backend(backend: str, device) -> str:
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown wire codec backend {backend!r}; "
                         "expected 'auto', 'kernel' or 'plain'")
    return backend


def wire_format(fmt: FixedPointFormat, wire_bits: int = WIRE_BITS
                ) -> FixedPointFormat:
    """Derive a wire ⟨IL, FL⟩ from a (wider) compute format: keep IL (the
    overflow guard, clipped to ``[1, wire_bits - 1]``) and spend the rest of
    ``wire_bits`` on fraction.  The training loop takes its wire formats from
    the ``wire_grads`` precision domain instead; this helper derives static
    wire formats for tools and tests."""
    if not 2 <= wire_bits <= WIRE_BITS:
        raise ValueError(f"wire_bits must be in [2, {WIRE_BITS}] for an int8 "
                         f"payload, got {wire_bits}")
    il = torch.clamp(fmt.il.to(torch.int32), 1, wire_bits - 1)
    return FixedPointFormat(il, (wire_bits - il).to(torch.int32))


def resolve_domain_format(formats, domain: str) -> FixedPointFormat:
    """One collective leg's ⟨IL, FL⟩ from a precision-domain registry: the
    ``{domain: FixedPointFormat}`` mapping of ``qtrain.bundle_formats`` (the
    leg picks out its own domain) or a bare :class:`FixedPointFormat`."""
    if isinstance(formats, FixedPointFormat):
        return formats
    try:
        fmt = formats[domain]
    except (KeyError, IndexError, TypeError):
        have = sorted(formats) if hasattr(formats, "keys") else type(formats)
        raise KeyError(
            f"no {domain!r} format in the registry mapping (have {have}); "
            "declare the wire domain in the PrecisionPlan or pass a "
            "FixedPointFormat directly") from None
    if not isinstance(fmt, FixedPointFormat):
        raise TypeError(f"registry entry {domain!r} is {type(fmt)}, "
                        "expected FixedPointFormat")
    return fmt


def _validate_capacity(fmt: FixedPointFormat):
    """Raise on over-wide formats (IL + FL > 8) held on the CPU.  A format
    on the device is not read (that would sync the host every step): the
    encode saturates at ±127 and counts the saturated elements into
    ``QuantStats.overflow``, as the reference does for traced formats."""
    if fmt.il.device.type != "cpu" or fmt.fl.device.type != "cpu":
        return
    total = fmt.il.to(torch.int64) + fmt.fl.to(torch.int64)
    if bool((total > WIRE_BITS).any()):
        raise ValueError(
            f"⟨IL, FL⟩ = ⟨{fmt.il.tolist()}, {fmt.fl.tolist()}⟩ exceeds the "
            f"int8 wire: IL + FL = {total.tolist()} > {WIRE_BITS}.  Grid "
            "integers would saturate at ±127; derive a wire format with "
            "wire_format(fmt) instead.")


# ---------------------------------------------------------------------------
# The group-aligned layout.
# ---------------------------------------------------------------------------

def _equal_group_sizes(size: int, groups: int) -> Tuple[int, ...]:
    """The default [G] split: equal ``ceil(size / G)`` contiguous chunks
    (the last possibly short or empty)."""
    chunk = -(-size // groups)
    return tuple(max(0, min(chunk, size - g * chunk)) for g in range(groups))


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Static group-aligned flat layout shared by kernels and collectives.

    Group ``g``'s payload occupies ``[offsets[g], offsets[g] +
    group_sizes[g])`` of the aligned buffer; the slot is padded to a
    multiple of ``quantum`` (one grouped-encode tile), so a tile never
    straddles groups.  The buffer is then padded to ``n_chunks`` equal,
    tile-aligned ``chunk``-element rank chunks (``total = n_chunks ·
    chunk``), so a collective boundary always falls on a tile boundary.
    All fields are Python ints.
    """

    group_sizes: Tuple[int, ...]
    quantum: int
    n_chunks: int
    padded: Tuple[int, ...]
    offsets: Tuple[int, ...]
    chunk: int
    total: int

    @property
    def size(self) -> int:
        return sum(self.group_sizes)

    @property
    def tiles(self) -> int:
        return self.total // self.quantum

    @property
    def is_exact(self) -> bool:
        """True when every group already sits at its aligned offset and no
        tail padding exists — align/dealign are then identities."""
        return self.total == self.size and all(
            p == s for p, s in zip(self.padded, self.group_sizes))

    def tile_groups(self) -> np.ndarray:
        """int32 ``[tiles]`` tile → group row (tail padding reads row 0,
        whose bytes there are zero)."""
        out = np.zeros((self.tiles,), np.int32)
        for g, (off, pad) in enumerate(zip(self.offsets, self.padded)):
            out[off // self.quantum:(off + pad) // self.quantum] = g
        return out

    def mask(self) -> np.ndarray:
        """float32 ``[total]`` validity (1 on payload, 0 on padding)."""
        out = np.zeros((self.total,), np.float32)
        for off, size in zip(self.offsets, self.group_sizes):
            out[off:off + size] = 1.0
        return out

    def align(self, flat: torch.Tensor) -> torch.Tensor:
        """Contiguous ``[size]`` payload → aligned ``[total]`` buffer
        (padding zero-filled; no copy when the layout is exact)."""
        if self.is_exact:
            return flat
        out = torch.zeros(self.total, dtype=flat.dtype, device=flat.device)
        off_in = 0
        for off, size in zip(self.offsets, self.group_sizes):
            out[off:off + size] = flat[off_in:off_in + size]
            off_in += size
        return out

    def dealign(self, aligned: torch.Tensor) -> torch.Tensor:
        """Aligned ``[total]`` buffer → contiguous ``[size]`` payload."""
        if self.is_exact:
            return aligned
        parts = [aligned[off:off + size]
                 for off, size in zip(self.offsets, self.group_sizes) if size]
        if not parts:
            return aligned[:0]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def group_layout(group_sizes, n_chunks: int = 1,
                 quantum: int = WIRE_GROUP_QUANTUM) -> GroupLayout:
    """The group-aligned layout for ``group_sizes`` payload groups split
    across ``n_chunks`` ranks."""
    sizes = tuple(int(s) for s in group_sizes)
    if any(s < 0 for s in sizes):
        raise ValueError(f"negative group size in {sizes}")
    padded = tuple(-(-s // quantum) * quantum for s in sizes)
    offsets, off = [], 0
    for p in padded:
        offsets.append(off)
        off += p
    chunk = quantum * -(-off // (n_chunks * quantum)) if off else quantum
    return GroupLayout(group_sizes=sizes, quantum=quantum, n_chunks=n_chunks,
                       padded=padded, offsets=tuple(offsets), chunk=chunk,
                       total=chunk * n_chunks)


@functools.lru_cache(maxsize=16)
def _layout_tables(layout: GroupLayout, device: str):
    """The layout's tile → group map (int32 ``[tiles]``) and group offsets
    (int64 ``[G]``) on ``device``, built once per layout."""
    return (torch.from_numpy(layout.tile_groups()).to(device),
            torch.tensor(layout.offsets, dtype=torch.int64, device=device))


def _layout_mask(layout: GroupLayout, device) -> torch.Tensor:
    return torch.from_numpy(layout.mask()).to(device)


def _group_ids(group_sizes, device=None) -> torch.Tensor:
    """int64 per-element group id for a contiguous (unaligned) split."""
    return torch.repeat_interleave(
        torch.arange(len(group_sizes), dtype=torch.int64, device=device),
        torch.tensor(group_sizes, dtype=torch.int64, device=device))


def _check_group_sizes(fmt: FixedPointFormat, group_sizes, total: int,
                       what: str = "x.numel()"):
    """``group_sizes`` (when given) must have one entry per format-table
    row and sum to the payload size."""
    if group_sizes is None:
        return
    groups = fmt.il.shape[0]
    if len(group_sizes) != groups or sum(group_sizes) != total:
        raise ValueError(
            f"group_sizes {tuple(group_sizes)} must have {groups} entries "
            f"(one per format-table row) summing to {what} = {total}")


def _segment_stats(s: QuantStats, ids: torch.Tensor, groups: int) -> QuantStats:
    """Per-tile/per-element QuantStats → ``[G]`` rows: counts summed as
    integers, sums in float64, each cast to float32 once."""
    dev = s.count.device

    def seg(v, dtype):
        out = torch.zeros(groups, dtype=dtype, device=dev)
        return out.index_add_(0, ids, v.to(dtype)).to(torch.float32)

    mx = torch.zeros(groups, dtype=torch.float32, device=dev)
    mx.scatter_reduce_(0, ids, s.max_abs, "amax")
    return QuantStats(
        count=seg(s.count, torch.int64), nonzero=seg(s.nonzero, torch.int64),
        overflow=seg(s.overflow, torch.int64),
        abs_err_sum=seg(s.abs_err_sum, torch.float64),
        rel_err_sum=seg(s.rel_err_sum, torch.float64),
        abs_sum=seg(s.abs_sum, torch.float64), max_abs=mx)


def _group_stream_bits(seed: int, group_sizes, device) -> torch.Tensor:
    """The dispatch words of a grouped encode in the payload's own order:
    group ``g`` takes the stream of ``fold_seed(seed, g)`` (what K3b draws
    over the aligned layout)."""
    parts = [philox_bits(fold_seed(seed, g), s, device)
             for g, s in enumerate(group_sizes)]
    return torch.cat(parts) if parts else torch.empty(0, dtype=torch.int32,
                                                       device=device)


def _aligned_bits(seed: int, layout: GroupLayout, goff, start: int,
                  length: int, *, onchip_prng: bool, group_base: int = 0):
    """The grouped encoder's bits over ``[start, start + length)`` of the
    aligned layout: group ``g`` takes the stream of ``fold_seed(seed,
    group_base + g)`` at the element's index in the group.  A
    :class:`GroupPhilox` (K3b) with ``onchip_prng``; else an int32 operand
    (K3) holding each overlapping group's :func:`ops.operand_bits` drawn
    over the whole group, zero on the padding."""
    if onchip_prng:
        return GroupPhilox(seed, goff, start=start, group_base=group_base)
    out = torch.zeros(length, dtype=torch.int32, device=goff.device)
    for g, (off, size) in enumerate(zip(layout.offsets, layout.group_sizes)):
        a, b = max(off, start), min(off + size, start + length)
        if a < b:
            out[a - start:b - start] = ops.operand_bits(
                fold_seed(seed, group_base + g), size,
                goff.device)[a - off:b - off]
    return out


# ---------------------------------------------------------------------------
# Encode and decode.
# ---------------------------------------------------------------------------

def _mark_encode(x, bits, mode: str, domain: Optional[str] = None) -> None:
    """The landmarks of one encode: its input, and its rounding bits."""
    if tagging.active() is None:
        return
    stochastic = mode == ROUND_STOCHASTIC
    kw = {} if domain is None else {"domain": domain}
    tagging.tag(x, "encode_in", stochastic=stochastic, **kw)
    if stochastic and bits is not None:
        tagging.tag(bits, "sr_bits", **kw)


def _encode_aligned(x_al: torch.Tensor, fmt: FixedPointFormat, tile_group,
                    mask, *, bits=None, mode: str, backend: str, quantum: int,
                    compute_stats: bool = True, out=None):
    """Grouped wire encode of a group-aligned ``[total]`` buffer: one launch
    of K3 (K3b with a :class:`GroupPhilox` source), or its plain version —
    per-tile ``wire_quantize`` and a fold of the tiles into group rows.
    Returns ``(wire int8 [total], [G]-shaped stats | None)``."""
    _mark_encode(x_al, bits, mode)
    return ops.dps_quantize_wire_grouped(
        x_al, fmt, tile_group, bits=bits, mask=mask,
        stochastic=mode == ROUND_STOCHASTIC, quantum=quantum,
        compute_stats=compute_stats, out=out, backend=backend)


def _encode_elementwise(x: torch.Tensor, fmt: FixedPointFormat, elem_group,
                        *, bits=None, mode: str, compute_stats: bool = True):
    """Grouped encode with per-ELEMENT group ids (no alignment assumed): the
    layout-agnostic plain path.  Formats are gathered per element, stats
    segment-reduce into ``[G]`` rows; the bytes equal the aligned path's
    given the same bits per element."""
    _mark_encode(x, bits, mode)
    gid = torch.as_tensor(elem_group, dtype=torch.int64, device=x.device)
    fmt_e = FixedPointFormat(fmt.il[gid], fmt.fl[gid])
    wire, s = wire_quantize(x.reshape(-1), fmt_e, mode=mode,
                            bits=None if bits is None else bits.reshape(-1),
                            compute_stats=compute_stats)
    stats = (_segment_stats(s, gid, fmt.il.shape[0]) if compute_stats
             else None)
    return wire, stats


def wire_encode(x: torch.Tensor, fmt: FixedPointFormat, *,
                seed: Optional[int] = None,
                bits: Optional[torch.Tensor] = None,
                mode: str = ROUND_STOCHASTIC,
                compute_stats: bool = True,
                backend: str = "auto",
                group_sizes: Optional[Tuple[int, ...]] = None,
                out: Optional[torch.Tensor] = None):
    """Quantize ``x`` onto the ⟨IL, FL⟩ grid and emit int8 grid integers.

    Over-wide formats held on the CPU raise; formats on the device saturate
    at ±127 with the saturated count folded into ``stats.overflow``.
    ``bits`` (32 per element) supplies the rounding noise; ``seed`` draws it
    from Philox (in the kernel on the card).

    A scalar format runs K2 (K2b with a seed).  Per-group formats
    (``fmt.il.shape == [G]``) split the flattened ``x`` into G contiguous
    groups — equal ``ceil(size / G)`` chunks by default, or ``group_sizes``
    — and return ``[G]`` stats; the ``kernel`` backend scatters the payload
    into the group-aligned layout and runs one K3 launch, the ``plain``
    backend encodes element-wise; the two give the same bytes.  With a
    seed, group ``g`` takes the stream of ``fold_seed(seed, g)``.

    ``out``: int8 with x's shape to write the wire into.  Returns ``(wire
    int8 with x's shape, stats | None)``.
    """
    if mode not in (ROUND_STOCHASTIC, ROUND_NEAREST):
        raise ValueError(f"unknown rounding mode {mode!r}")
    _validate_capacity(fmt)
    stochastic = mode == ROUND_STOCHASTIC
    if stochastic and bits is None and seed is None:
        raise ValueError("stochastic rounding needs `bits` or `seed`")
    be = _resolve_backend(backend, x.device)
    if fmt.il.ndim == 0:
        if group_sizes is not None:
            raise ValueError("group_sizes needs a [G]-shaped format")
        src = None
        if stochastic:
            src = bits.reshape(-1) if bits is not None else Philox(seed)
        _mark_encode(x, src, mode)
        return ops.dps_quantize_wire(x, fmt, src, compute_stats=compute_stats,
                                     out=out, backend=be)

    if fmt.il.ndim != 1:
        raise ValueError(f"per-group formats must be rank-1 [G], got shape "
                         f"{tuple(fmt.il.shape)}")
    groups, n = fmt.il.shape[0], x.numel()
    if group_sizes is not None:
        group_sizes = tuple(int(s) for s in group_sizes)
        _check_group_sizes(fmt, group_sizes, n)
    sizes = group_sizes or _equal_group_sizes(n, groups)
    if be == "kernel":
        wire, stats = _wire_encode_aligned(
            x, fmt, sizes, bits, seed, mode=mode, compute_stats=compute_stats,
            backend=be, quantum=default_wire_quantum(n, groups))
    else:
        if stochastic and bits is None:
            bits = _group_stream_bits(seed, sizes, x.device)
        wire, stats = _encode_elementwise(
            x, fmt, _group_ids(sizes, x.device), bits=bits, mode=mode,
            compute_stats=compute_stats)
        wire = wire.reshape(x.shape)
    if out is not None:
        out.copy_(wire)
        wire = out
    return wire, stats


def _wire_encode_aligned(x, fmt, sizes, bits, seed, *, mode, compute_stats,
                         backend, quantum):
    """:func:`wire_encode`'s grouped route on the kernel backend: ``x``
    scattered into the group-aligned layout of ``sizes``, one grouped
    encode (``bits`` aligned with it, or a :class:`GroupPhilox` stream of
    ``seed``), the wire gathered back into x's layout."""
    layout = group_layout(sizes, quantum=quantum)
    tg, goff = _layout_tables(layout, str(x.device))
    src = None
    if mode == ROUND_STOCHASTIC:
        src = (layout.align(bits.reshape(-1)) if bits is not None
               else GroupPhilox(seed, goff))
    wire_al, stats = _encode_aligned(
        layout.align(x.reshape(-1)), fmt, tg, _layout_mask(layout, x.device),
        bits=src, mode=mode, backend=backend, quantum=layout.quantum,
        compute_stats=compute_stats)
    return layout.dealign(wire_al).reshape(x.shape), stats


def wire_decode(wire: torch.Tensor, fmt: FixedPointFormat,
                dtype=torch.float32,
                group_sizes: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Grid integers (int8) back to values: ``wire * 2^-FL``, for the same
    scalar or ``[G]`` formats (and ``group_sizes`` split) as
    :func:`wire_encode`."""
    if fmt.il.ndim == 0:
        return tagging.tag(
            (wire.to(torch.float32) * exp2_int(-fmt.fl)).to(dtype),
            "decode_out")
    sizes = (tuple(group_sizes) if group_sizes is not None
             else _equal_group_sizes(wire.numel(), fmt.il.shape[0]))
    inv = exp2_int(-fmt.fl)[_group_ids(sizes, wire.device)]
    return tagging.tag((wire.reshape(-1).to(torch.float32) * inv).reshape(
        wire.shape).to(dtype), "decode_out")


def _wire_reduce(wire: torch.Tensor, fmt: FixedPointFormat, tile_group, *,
                 backend: str, quantum: int) -> torch.Tensor:
    """Receive leg: ``(n, chunk)`` int8 → fp32 ``[chunk]`` mean — K4, or its
    plain version; bit-identical (every decoded value is an exact fp32
    multiple of its group's 2^-FL)."""
    return ops.dps_wire_reduce(wire, fmt, tile_group, quantum=quantum,
                               backend=backend)


def _decode_aligned(wire_al: torch.Tensor, fmt: FixedPointFormat, tile_group,
                    quantum: int, dtype=torch.float32) -> torch.Tensor:
    """Aligned ``[total]`` int8 → values, per-tile FL from the table."""
    inv = exp2_int(-fmt.fl)[tile_group.to(torch.int64)]
    dec = wire_al.reshape(-1, quantum).to(torch.float32) * inv[:, None]
    return tagging.tag(dec.reshape(-1).to(dtype), "decode_out")


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------

def psum_stats(stats: Sequence[QuantStats], transport) -> QuantStats:
    """Combine the :class:`QuantStats` of the ranks this process holds (one
    entry each) across the whole axis: sums add, ``max_abs`` maxes."""
    field = lambda name: torch.stack([getattr(s, name) for s in stats])
    summed = [transport.psum(field(n)) for n in
              ("count", "nonzero", "overflow", "abs_err_sum", "rel_err_sum",
               "abs_sum")]
    return QuantStats(*summed, max_abs=transport.pmax(field("max_abs")))


def _rank_chunk(size: int, n: int) -> int:
    """Elements per rank chunk of a global-format payload of ``size``."""
    a = WIRE_CHUNK_ALIGN
    return max(a, a * -(-size // (a * n)))


def _owner_rs_snap(received_i: torch.Tensor, fmt: FixedPointFormat,
                   layout: GroupLayout, j: int, tg_all, goff, k2s: int, *,
                   mode: str, backend: str, onchip_prng: bool = True,
                   group_offset: int = 0, out=None):
    """Owner ``j``'s half of :func:`_aligned_rs_snap`: K4 on its received
    ``[n, chunk]`` stack, then the leg-2 re-encode of the mean chunk (K3b,
    or K3 with a bits operand, under stochastic rounding; no statistics)
    into ``out``.  Returns ``(part fp32 [chunk], wire2 int8 [chunk],
    my_tg)``."""
    tpc = layout.chunk // layout.quantum
    my_tg = tg_all[j * tpc:(j + 1) * tpc]
    part = _wire_reduce(received_i, fmt, my_tg, backend=backend,
                        quantum=layout.quantum)
    bits2 = (_aligned_bits(k2s, layout, goff, j * layout.chunk, layout.chunk,
                           onchip_prng=onchip_prng, group_base=group_offset)
             if mode == ROUND_STOCHASTIC else None)
    wire2, _ = _encode_aligned(part, fmt, my_tg, None, bits=bits2, mode=mode,
                               backend=backend, quantum=layout.quantum,
                               compute_stats=False, out=out)
    return part, wire2, my_tg


def _aligned_rs_snap(fmt: FixedPointFormat, layout: GroupLayout, transport,
                     encode_leg1, k2s: int, *, mode: str, backend: str,
                     onchip_prng: bool = True, group_offset: int = 0):
    """Compressed reduce-scatter + wire-grid snap of a group-aligned payload.

    ``encode_leg1(tile_groups, goff) -> (payload int8 [rows, total], stats
    per row)`` encodes the dispatch leg.  Then the tiled ``all_to_all``, and
    for each owned chunk in turn :func:`_owner_rs_snap` (which also hands
    back the owner's raw fp32 mean chunk, as the reference's does; this
    loop keeps only the int8 snap, one fp32 chunk existing at a time): K4,
    and the leg-2 re-encode of the mean chunk — the values the all-reduce's
    gather leg would carry, which a sharded consumer decodes locally.  Leg-2
    bits: group ``g`` draws the stream of ``fold_seed(k2s, group_offset +
    g)`` at the element's index in the group, so any layout of the groups
    (one buffer, buckets, shards) draws the same bits.  Returns ``(wire2
    int8 [rows, chunk], stats per row, my_tgs)``, ``my_tgs`` each owner's
    tile → group map.
    """
    tg_all, goff = _layout_tables(layout, str(fmt.il.device))
    payload, stats = encode_leg1(tg_all, goff)
    tagging.tag(payload, "wire_payload", leg="dispatch")
    received = transport.all_to_all(payload)
    del payload
    owned = list(transport.ranks)
    wire2 = torch.empty(len(owned), layout.chunk, dtype=torch.int8,
                        device=received.device)
    my_tgs = []
    for i, j in enumerate(owned):
        _, _, my_tg = _owner_rs_snap(
            received[i], fmt, layout, j, tg_all, goff, k2s, mode=mode,
            backend=backend, onchip_prng=onchip_prng,
            group_offset=group_offset, out=wire2[i])
        my_tgs.append(my_tg)
    return wire2, stats, my_tgs


def _aligned_allreduce_mean(x_als: Sequence[torch.Tensor],
                            fmt: FixedPointFormat, layout: GroupLayout,
                            transport, seed: int, k2s: int, *, mode: str,
                            backend: str, onchip_prng: bool = True):
    """Both compressed legs over per-rank group-aligned ``[total]`` fp32
    buffers: K3 (with statistics, masked) on each rank's buffer, then
    :func:`_aligned_rs_snap`, the int8 ``all_gather`` and the per-tile
    decode.  Returns ``(mean_al fp32 [total], stats per rank)``."""
    stochastic = mode == ROUND_STOCHASTIC
    dev = x_als[0].device

    def encode_leg1(tg_all, goff):
        payload = torch.empty(len(x_als), layout.total, dtype=torch.int8,
                              device=dev)
        mask = _layout_mask(layout, dev)
        stats = []
        for row, (r, x_al) in enumerate(zip(transport.ranks, x_als)):
            bits = (_aligned_bits(fold_seed(seed, r), layout, goff, 0,
                                  layout.total, onchip_prng=onchip_prng)
                    if stochastic else None)
            _, s = _encode_aligned(x_al, fmt, tg_all, mask, bits=bits,
                                   mode=mode, backend=backend,
                                   quantum=layout.quantum, out=payload[row])
            stats.append(s)
        return payload, stats

    wire2, stats, _ = _aligned_rs_snap(fmt, layout, transport, encode_leg1,
                                       k2s, mode=mode, backend=backend,
                                       onchip_prng=onchip_prng)
    tagging.tag(wire2, "wire_payload", leg="gather")
    full = transport.all_gather(wire2)
    tg_all, _ = _layout_tables(layout, str(fmt.il.device))
    return _decode_aligned(full, fmt, tg_all, layout.quantum), stats


def dps_allreduce_mean(xs: Sequence[torch.Tensor], formats, transport,
                       seed: int, *, mode: str = ROUND_STOCHASTIC,
                       backend: str = "auto", domain: str = "wire_grads",
                       group_sizes: Optional[Tuple[int, ...]] = None,
                       quantum: Optional[int] = None,
                       onchip_prng: bool = True
                       ) -> Tuple[torch.Tensor, List[QuantStats]]:
    """Mean over the data axis of per-rank tensors, with an int8 wire.

    ``xs``: one tensor per rank the transport holds (same shape).  Leg 1:
    each rank quantizes its tensor and ships int8 through a tiled
    ``all_to_all``, owner j receiving every rank's chunk j; the owner
    decodes and means (K4), re-quantizes the mean chunk, and leg 2
    ``all_gather``s the int8 back out.  With stochastic rounding each leg's
    error is below one grid step (2^-FL).  A scalar format is the tree
    all-reduce of a one-leaf tree; a ``[G]``-shaped format runs one ⟨IL, FL⟩
    per contiguous group (``group_sizes``, default equal chunks) through
    both legs in the group-aligned layout.

    Returns ``(mean, stats)``: the mean (xs' shape and dtype, the same on
    every rank) and, per rank held, the dispatch leg's stats of its |x|
    elements (:func:`psum_stats` combines them).  ``quantum=None`` derives
    the grouped layout's tile per :func:`default_wire_quantum`; the result
    is layout-invariant.  ``onchip_prng``: the bit source (module
    docstring).
    """
    fmt = resolve_domain_format(formats, domain)
    if len(xs) != len(transport.ranks):
        raise ValueError(f"{len(xs)} inputs for the {len(transport.ranks)} "
                         "ranks this transport holds")
    if fmt.il.ndim == 0:
        if group_sizes is not None:
            raise ValueError("group_sizes needs a [G]-shaped format")
        mean, stats = dps_allreduce_mean_tree(
            [{"x": x} for x in xs], fmt, transport, seed, mode=mode,
            backend=backend, onchip_prng=onchip_prng)
        return mean["x"], stats
    if mode not in (ROUND_STOCHASTIC, ROUND_NEAREST):
        raise ValueError(f"unknown rounding mode {mode!r}")
    _validate_capacity(fmt)
    x0 = xs[0]
    be = _resolve_backend(backend, x0.device)
    size, groups = x0.numel(), fmt.il.shape[0]
    _check_group_sizes(fmt, group_sizes, size)
    layout = group_layout(group_sizes or _equal_group_sizes(size, groups),
                          n_chunks=transport.axis_size,
                          quantum=quantum or default_wire_quantum(size, groups))
    mean_al, stats = _aligned_allreduce_mean(
        [layout.align(x.reshape(-1).to(torch.float32)) for x in xs], fmt,
        layout, transport, seed, fold_seed(seed, LEG2), mode=mode, backend=be,
        onchip_prng=onchip_prng)
    return (layout.dealign(mean_al).reshape(x0.shape).to(x0.dtype),
            tagging.tag_tree(stats, "wire_stats", domain=domain))


def _zero_chunk(size: int, n: int) -> int:
    """Elements per rank of a ZeRO flat vector of ``size`` (the plain
    partitioner's ``shard_size``): ``ceil(size / n)``, unrounded."""
    return -(-size // n)


def _flat_bits(seed: int, size: int, device, onchip_prng: bool,
               words: bool = False):
    """One stream of ``seed`` over a whole flat vector: a :class:`Philox`
    source for the kernel (``words``: its words, for the per-element codec)
    or an operand."""
    if not onchip_prng:
        return ops.operand_bits(seed, size, device)
    return philox_bits(seed, size, device) if words else Philox(seed)


def dps_reduce_scatter_mean(xs: Sequence[torch.Tensor], formats, transport,
                            seed: int, *, mode: str = ROUND_STOCHASTIC,
                            backend: str = "auto", domain: str = "wire_grads",
                            group_sizes: Optional[Tuple[int, ...]] = None,
                            onchip_prng: bool = True
                            ) -> Tuple[torch.Tensor, List[QuantStats]]:
    """Reduce-scatter mean over the data axis with the int8 wire on the
    scatter leg: the ZeRO-1 gradient half-collective.

    ``xs``: one tensor per rank the transport holds.  Owner ``j`` ends up
    with the mean of every rank's chunk ``j`` of the (flattened) tensor
    (``ceil(size / n)`` elements, the plain
    :class:`~repro_torch.dist.sharding.ZeroPartitioner` shard).  Where the
    all-reduce would re-quantize that mean and gather it, ZeRO keeps it
    sharded: each owner steps its slice of the optimizer
    (:func:`dps_allgather_params` is the return leg).

    A scalar format is the dispatch leg of a one-leaf
    :class:`TreeAllReduce` over rank chunks of that size (K2, K2b with
    ``onchip_prng``, rank ``r`` drawing leaf 0's stream of ``fold_seed(seed,
    r)``), then :meth:`TreeAllReduce.owner_mean` (K4) for each owner: the
    route the train step's plain ZeRO layout runs.

    A ``[G]``-shaped format splits the flattened ``x`` into contiguous groups
    (``group_sizes``, default equal chunks) and returns ``[G]`` stats.  The
    chunk layout is the caller's, so group boundaries need not fall on
    chunk boundaries: the per-element codec runs (the plain versions; an
    explicit ``backend="kernel"`` raises).  The train step's per-leaf ZeRO
    runs the group-aligned layout through
    :func:`repro_torch.dist.overlap.zero_bucketed_reduce_scatter` instead.

    Returns ``(shards fp32 [rows, chunk], stats per rank held)``: row ``i``
    is owner ``transport.ranks[i]``'s chunk of the zero-padded mean, the
    stats cover each rank's encode of its |x| elements.
    """
    fmt = resolve_domain_format(formats, domain)
    _validate_capacity(fmt)
    if mode not in (ROUND_STOCHASTIC, ROUND_NEAREST):
        raise ValueError(f"unknown rounding mode {mode!r}")
    if len(xs) != len(transport.ranks):
        raise ValueError(f"{len(xs)} inputs for the {len(transport.ranks)} "
                         "ranks this transport holds")
    n, size, dev = transport.axis_size, xs[0].numel(), xs[0].device
    chunk = _zero_chunk(size, n)
    if fmt.il.ndim == 0:
        tw = TreeAllReduce([xs[0].reshape(-1)], fmt, transport, seed,
                           mode=mode, backend=backend,
                           onchip_prng=onchip_prng, chunk=chunk)
        for r, x in zip(transport.ranks, xs):
            tw.encode(r, [x.reshape(-1)])
        stats = tw.stats
        return torch.stack([tw.owner_mean(i) for i in range(len(xs))]), stats
    if backend == "kernel":
        raise ValueError(
            "dps_reduce_scatter_mean runs [G]-shaped formats with the "
            "per-element codec (the chunk layout is the caller's, so group "
            "boundaries need not fall on tiles); an explicit "
            "backend='kernel' cannot be honored — use backend='auto', or "
            "zero_bucketed_reduce_scatter for the group-aligned kernels")
    _check_group_sizes(fmt, group_sizes, size)
    gs = group_sizes or _equal_group_sizes(size, fmt.il.shape[0])
    gid = _group_ids(gs, dev)
    stochastic = mode == ROUND_STOCHASTIC
    payload = torch.zeros(len(xs), n * chunk, dtype=torch.int8, device=dev)
    stats = []
    for row, (r, x) in enumerate(zip(transport.ranks, xs)):
        bits = (_flat_bits(fold_seed(seed, r), size, dev, onchip_prng,
                           words=True) if stochastic else None)
        w, s = _encode_elementwise(x.reshape(-1), fmt, gid, bits=bits,
                                   mode=mode)
        payload[row, :size] = w
        stats.append(s)
    tagging.tag(payload, "wire_payload", leg="dispatch", domain=domain)
    received = transport.all_to_all(payload)
    del payload
    inv = torch.zeros(n * chunk, dtype=torch.float32, device=dev)
    inv[:size] = exp2_int(-fmt.fl)[gid]
    ntensor = torch.tensor(float(n), device=dev)
    shards = torch.stack([
        (received[i].to(torch.float32)
         * inv[j * chunk:(j + 1) * chunk][None, :]).sum(0) / ntensor
        for i, j in enumerate(transport.ranks)])
    return shards, tagging.tag_tree(stats, "wire_stats", domain=domain)


def dps_allgather_params(shards, formats, transport,
                         seed: int, *, mode: str = ROUND_STOCHASTIC,
                         backend: str = "auto", domain: str = "wire_params",
                         group_sizes: Optional[Tuple[int, ...]] = None,
                         onchip_prng: bool = True,
                         out: Optional[torch.Tensor] = None, keep=None
                         ) -> Tuple[torch.Tensor, List[QuantStats]]:
    """All-gather the ranks' parameter shards over an int8 wire: the ZeRO
    return leg.

    ``shards``: one ``[chunk]`` tensor per rank the transport holds (the
    slice of the flat parameter vector it just stepped).  Each is
    quantized onto the ⟨IL, FL⟩ grid (K2/K2b; rank ``r`` takes the stream of
    ``fold_seed(seed, r)``) and the int8 chunks are gathered and decoded on
    every rank: the parameters come back on the ``wire_params`` grid, whose
    controller the returned stats feed.  A ``[G]``-shaped format partitions
    the GATHERED vector into contiguous groups (``group_sizes``), each rank
    encoding its shard with the formats of its own positions (the
    per-element codec).

    Returns ``(full fp32 [n·chunk], stats per rank held)``; ``out`` (fp32
    ``[n·chunk]``) receives the decode — it may be the buffer the shards
    are views of: every shard is encoded before the decode writes.
    ``shards`` may also be a callable ``(row, rank) -> shard``, called for
    each rank held in order just before its encode (a caller that makes
    each shard when it is needed).  ``keep`` (a bool device scalar, the
    health guards' skip gate): the decode writes ``out`` only where it
    holds, ``out`` keeping its old values elsewhere.
    """
    fmt = resolve_domain_format(formats, domain)
    _validate_capacity(fmt)
    if mode not in (ROUND_STOCHASTIC, ROUND_NEAREST):
        raise ValueError(f"unknown rounding mode {mode!r}")
    rows = list(transport.ranks)
    get = shards if callable(shards) else None
    if get is None and len(shards) != len(rows):
        raise ValueError(f"{len(shards)} shards for the "
                         f"{len(rows)} ranks this transport holds")
    first = get(0, rows[0]) if get is not None else shards[0]
    n, chunk, dev = transport.axis_size, first.numel(), first.device
    stochastic = mode == ROUND_STOCHASTIC
    wire = torch.empty(len(rows), chunk, dtype=torch.int8, device=dev)
    stats = []
    grouped = fmt.il.ndim != 0
    if grouped:
        if backend == "kernel":
            raise ValueError(
                "dps_allgather_params runs [G]-shaped formats with the "
                "per-element codec; an explicit backend='kernel' cannot be "
                "honored — use backend='auto', or zero_allgather_params")
        _check_group_sizes(fmt, group_sizes, n * chunk,
                           what="the gathered vector size")
        gid = _group_ids(group_sizes
                         or _equal_group_sizes(n * chunk, fmt.il.shape[0]),
                         dev)
    else:
        be = _resolve_backend(backend, dev)
    for row, r in enumerate(rows):
        if row == 0:
            x, first = first, None
        else:
            x = get(row, r) if get is not None else shards[row]
        bits = (_flat_bits(fold_seed(seed, r), chunk, dev, onchip_prng,
                           words=grouped) if stochastic else None)
        if grouped:
            w, s = _encode_elementwise(x.reshape(-1), fmt,
                                       gid[r * chunk:(r + 1) * chunk],
                                       bits=bits, mode=mode)
            wire[row] = w
        else:
            _mark_encode(x, bits, mode, domain)
            _, s = ops.dps_quantize_wire(x.reshape(-1), fmt, bits,
                                         out=wire[row], backend=be)
        stats.append(s)
        del x
    tagging.tag(wire, "wire_payload", leg="gather", domain=domain)
    full = transport.all_gather(wire)
    del wire
    if out is None:
        out = torch.empty(n * chunk, dtype=torch.float32, device=dev)
    inv = exp2_int(-fmt.fl)
    for j in range(n):         # chunk by chunk: one fp32 chunk at a time
        sl = slice(j * chunk, (j + 1) * chunk)
        scale = inv[gid[sl]] if grouped else inv
        if keep is None:
            torch.mul(full[sl].to(torch.float32), scale, out=out[sl])
        else:
            torch.where(keep, full[sl].to(torch.float32) * scale, out[sl],
                        out=out[sl])
    tagging.tag(out, "decode_out", domain=domain)
    return out, tagging.tag_tree(stats, "wire_stats", domain=domain)


class TreeAllReduce:
    """:func:`dps_allreduce_mean_tree` in steps, for a caller that cannot
    hold every rank's tree at once (n fp32 gradient trees of a 3 B-parameter
    model do not fit beside the training state).

    ``encode(rank, tree)`` (or ``encode_leaf`` leaf by leaf, in any order)
    runs the dispatch leg of one rank the transport holds: each leaf is
    encoded by K2 (K2b with ``onchip_prng``) straight into its slot of that
    rank's row of ONE int8 payload, and may be dropped right after.
    ``start()`` hands the payload to the tiled ``all_to_all`` (asynchronous
    on a process group), ``scatter_snap()`` runs K4 on each owned chunk and
    the leg-2 re-encode (the reduce-scatter half: ``decode_owned(i)`` is
    owner ``i``'s chunk of the mean), and ``finish()`` adds the int8
    ``all_gather`` and decodes the mean leaf by leaf.

    A ``[G]``-shaped format (G = leaf count) runs one ⟨IL, FL⟩ per leaf in the
    group-aligned layout, leg 2 on K3b (K3); a scalar format packs the
    leaves exactly (rank chunks of ``chunk`` elements, default rounded to 16),
    K4 reads a one-row table and leg 2 runs K2b (K2) on each leaf's part of
    the owned chunk.  ``layout``: an explicit group-aligned layout (a ZeRO
    partitioner's bucket); a scalar format then runs aligned too, as ``G``
    identical rows, and its statistics merge to one row.

    ``like`` is a tree, or a list of leaves whose global leaf indices start
    at ``group_base`` (a bucket of a larger tree): rounding streams and
    format rows are keyed by the global index, so a bucket draws the bits
    the whole tree's collective would.

    ``payload_fault``: the fault-injection hook
    (:func:`repro_torch.resilience.payload_fault_fn`), applied in place to
    the encoded payload (every held rank's dispatch-leg buffer, its
    statistics already taken) just before the all-to-all.
    """

    def __init__(self, like, formats, transport, seed: int, *,
                 mode: str = ROUND_STOCHASTIC, backend: str = "auto",
                 domain: str = "wire_grads", quantum: Optional[int] = None,
                 onchip_prng: bool = True, group_base: int = 0,
                 layout: Optional[GroupLayout] = None,
                 chunk: Optional[int] = None, payload_fault=None):
        fmt = resolve_domain_format(formats, domain)
        _validate_capacity(fmt)
        self.payload_fault = payload_fault
        if mode not in (ROUND_STOCHASTIC, ROUND_NEAREST):
            raise ValueError(f"unknown rounding mode {mode!r}")
        listed = isinstance(like, (list, tuple))
        leaves = list(like) if listed else tree_lib.leaves(like)
        if not leaves:
            raise ValueError("an empty tree has nothing to all-reduce")
        G = len(leaves)
        self.merge_scalar = fmt.il.ndim == 0 and layout is not None
        if self.merge_scalar:        # the aligned codec reads a row table
            fmt = FixedPointFormat(fmt.il.reshape(1).expand(G),
                                   fmt.fl.reshape(1).expand(G))
        self.grouped = fmt.il.ndim != 0
        if self.grouped and fmt.il.shape[0] != G:
            raise ValueError(
                f"[G]-shaped tree formats are one ⟨IL, FL⟩ per leaf: the "
                f"table has {fmt.il.shape[0]} rows, the tree {G} leaves")
        self.fmt, self.transport, self.seed, self.mode = (fmt, transport,
                                                          seed, mode)
        self.domain = domain
        self.onchip_prng, self.group_base = onchip_prng, group_base
        # the tree's structure only: holding its tensors would keep them
        # alive until finish()
        self.skeleton = None if listed else tree_lib.map_tree(lambda _: None,
                                                              like)
        self.sizes = tuple(l.numel() for l in leaves)
        self.shapes = tuple(l.shape for l in leaves)
        self.dtypes = tuple(l.dtype for l in leaves)
        self.device = leaves[0].device
        self.backend = _resolve_backend(backend, self.device)
        n = transport.axis_size
        if layout is not None:
            if tuple(layout.group_sizes) != self.sizes or layout.n_chunks != n:
                raise ValueError(
                    f"layout of groups {layout.group_sizes} over "
                    f"{layout.n_chunks} chunks does not hold leaves of sizes "
                    f"{self.sizes} over {n} ranks")
            self.layout = layout
        elif self.grouped:
            q = quantum or default_wire_quantum(sum(self.sizes), G)
            self.layout = group_layout(self.sizes, n_chunks=n, quantum=q)
        else:
            self.layout = None
        if self.layout is not None:
            self.offsets, self.chunk = self.layout.offsets, self.layout.chunk
        else:
            self.chunk = chunk or _rank_chunk(sum(self.sizes), n)
            if self.chunk * n < sum(self.sizes):
                raise ValueError(f"{n} chunks of {self.chunk} cannot hold "
                                 f"{sum(self.sizes)} elements")
            self.offsets = tuple(int(o) for o in
                                 np.cumsum((0,) + self.sizes[:-1]))
        self.rows = list(transport.ranks)
        # zeros: alignment and tail padding must be zero bytes on the wire
        self.payload = torch.zeros(len(self.rows), self.chunk * n,
                                   dtype=torch.int8, device=self.device)
        self.leaf_stats = [[None] * G for _ in self.rows]
        self.received = self._work = self.wire2 = None

    def _leaf_fmt(self, g: int) -> FixedPointFormat:
        if not self.grouped:
            return self.fmt
        return FixedPointFormat(self.fmt.il[g], self.fmt.fl[g])

    def _leaf_bits(self, seed: int, g: int, a: int, b: int):
        """Leaf ``g``'s stream of ``seed`` over its elements ``[a, b)``:
        ``None`` under nearest rounding, else a :class:`Philox` (K2b) or the
        slice of an operand drawn over the whole leaf (K2)."""
        if self.mode != ROUND_STOCHASTIC:
            return None
        if self.onchip_prng:
            return Philox(seed, a)
        return ops.operand_bits(seed, self.sizes[g], self.device)[a:b]

    def encode_leaf(self, rank: int, g: int, leaf: torch.Tensor) -> QuantStats:
        """Leg 1 of ``rank``'s leaf ``g`` (local index) into its slot.
        Returns the leaf's dispatch-leg stats."""
        if self.payload is None:
            raise RuntimeError("the payload has left for the all-to-all")
        row = self.rows.index(rank)
        if leaf.numel() != self.sizes[g]:
            raise ValueError(f"leaf {g}: {leaf.numel()} elements, the layout "
                             f"holds {self.sizes[g]}")
        off, size = self.offsets[g], self.sizes[g]
        seed = fold_seed(fold_seed(self.seed, rank), self.group_base + g)
        bits = self._leaf_bits(seed, g, 0, size)
        _mark_encode(leaf, bits, self.mode, self.domain)
        _, s = ops.dps_quantize_wire(
            leaf, self._leaf_fmt(g), bits,
            out=self.payload[row, off:off + size].view(leaf.shape),
            backend=self.backend)
        self.leaf_stats[row][g] = s
        return s

    def encode(self, rank: int, tree) -> QuantStats:
        """Leg 1 of ``rank``: its tree's leaves into its payload row.
        Returns the rank's dispatch-leg stats (``[G]`` or scalar)."""
        leaves = list(tree) if isinstance(tree, (list, tuple)) \
            else tree_lib.leaves(tree)
        if tuple(l.numel() for l in leaves) != self.sizes:
            raise ValueError("the tree's leaves differ from the layout's")
        for g, leaf in enumerate(leaves):
            self.encode_leaf(rank, g, leaf)
        return self.rank_stats(self.rows.index(rank))

    def rank_stats(self, row: int) -> QuantStats:
        """Row ``row``'s dispatch-leg stats: ``[G]``-stacked in leaf order,
        or merged in leaf order for a scalar format."""
        per_leaf = self.leaf_stats[row]
        if any(s is None for s in per_leaf):
            raise RuntimeError("encode every leaf of every rank the "
                               "transport holds first")
        if self.grouped and not self.merge_scalar:
            out = QuantStats(*(torch.stack([getattr(s, f.name)
                                            for s in per_leaf])
                               for f in dataclasses.fields(QuantStats)))
        else:
            out = merge_stats(*per_leaf)
        return tagging.tag_tree(out, "wire_stats", domain=self.domain)

    @property
    def stats(self) -> List[QuantStats]:
        return [self.rank_stats(i) for i in range(len(self.rows))]

    def start(self):
        """Hand the payload to the tiled ``all_to_all`` (issued
        asynchronously on a process group; waited on before K4)."""
        if self.received is not None or self.wire2 is not None:
            return
        if any(s is None for row in self.leaf_stats for s in row):
            raise RuntimeError("encode() every rank the transport holds "
                               "before the all-to-all")
        payload, self.payload = self.payload, None
        if self.payload_fault is not None:
            self.payload_fault(payload)        # fault injection, in place
        tagging.tag(payload, "wire_payload", leg="dispatch", domain=self.domain)
        self.received, self._work = self.transport.all_to_all(payload,
                                                              async_op=True)

    def _take_received(self):
        self.start()
        if self._work is not None:
            self._work.wait()
        received, self.received, self._work = self.received, None, None
        return received

    def scatter_snap(self) -> torch.Tensor:
        """The reduce-scatter half: K4 on each owned chunk, the leg-2
        re-encode; returns (and keeps) ``wire2`` int8 ``[rows, chunk]``,
        and releases the payload."""
        if self.wire2 is not None:
            return self.wire2
        received = self._take_received()
        if self.layout is not None:
            tg_all, goff = _layout_tables(self.layout, str(self.device))
            wire2 = torch.empty(len(self.rows), self.chunk, dtype=torch.int8,
                                device=self.device)
            for i, j in enumerate(self.rows):
                _owner_rs_snap(received[i], self.fmt, self.layout, j, tg_all,
                               goff, fold_seed(self.seed, LEG2), mode=self.mode,
                               backend=self.backend,
                               onchip_prng=self.onchip_prng,
                               group_offset=self.group_base, out=wire2[i])
        else:
            wire2 = self._scalar_rs_snap(received, fold_seed(self.seed, LEG2))
        del received
        self.wire2 = wire2
        return wire2

    def owner_mean(self, i: int) -> torch.Tensor:
        """Owner row ``i``'s raw fp32 mean chunk of a packed (scalar)
        layout: K4 without the leg-2 snap, the plain ZeRO reduce-scatter.
        The received payload lives as long as this object does."""
        if self.layout is not None:
            raise ValueError("owner_mean reads a packed payload; an aligned "
                             "layout's owners decode_owned() their snap")
        if self.received is None or self._work is not None:
            self.received = self._take_received()
        return _wire_reduce(self.received[i], self.fmt, None,
                            backend=self.backend, quantum=self.chunk)

    def decode_owned(self, i: int) -> torch.Tensor:
        """Owner row ``i``'s fp32 ``[chunk]`` of the mean (aligned layouts):
        its ``wire2`` decoded locally, bit-equal to its chunk of
        :meth:`finish`'s."""
        if self.layout is None:
            raise ValueError("decode_owned needs a group-aligned layout")
        wire2 = self.scatter_snap()[i]
        tg_all, _ = _layout_tables(self.layout, str(self.device))
        tpc = self.chunk // self.layout.quantum
        j = self.rows[i]
        return _decode_aligned(wire2, self.fmt, tg_all[j * tpc:(j + 1) * tpc],
                               self.layout.quantum)

    def finish(self):
        """Legs after the dispatch: returns ``(mean tree, stats per rank
        held)``; the payload is released."""
        stats = self.stats
        wire2 = self.scatter_snap()
        self.wire2 = None
        tagging.tag(wire2, "wire_payload", leg="gather", domain=self.domain)
        full = self.transport.all_gather(wire2)
        del wire2
        out = []
        for g, (off, size) in enumerate(zip(self.offsets, self.sizes)):
            inv = exp2_int(-self._leaf_fmt(g).fl)
            dec = full[off:off + size].to(torch.float32).mul_(inv)
            out.append(tagging.tag(dec.view(self.shapes[g]).to(self.dtypes[g]),
                                   "decode_out", domain=self.domain))
        if self.skeleton is None:
            return out, stats
        return tree_lib.from_leaves(self.skeleton, out), stats

    def _scalar_rs_snap(self, received, k2s: int) -> torch.Tensor:
        c = self.chunk
        wire2 = torch.zeros(len(self.rows), c, dtype=torch.int8,
                            device=self.device)
        for i, j in enumerate(self.rows):
            part = _wire_reduce(received[i], self.fmt, None,
                                backend=self.backend, quantum=c)
            # leg 2 leaf by leaf over the owned chunk, each piece keyed by
            # its leaf and its offset in the leaf
            for g, (off, size) in enumerate(zip(self.offsets, self.sizes)):
                a, b = max(off, j * c), min(off + size, (j + 1) * c)
                if a >= b:
                    continue
                piece = part[a - j * c:b - j * c]
                bits = self._leaf_bits(fold_seed(k2s, self.group_base + g), g,
                                       a - off, b - off)
                _mark_encode(piece, bits, self.mode, self.domain)
                ops.dps_quantize_wire(
                    piece, self.fmt, bits, compute_stats=False,
                    out=wire2[i, a - j * c:b - j * c], backend=self.backend)
            del part
        return wire2


class F32TreeMean:
    """The int8 wire's fp32 fallback, the health guards' degrade branch:
    the exact per-leaf mean over the ranks, with :class:`TreeAllReduce`'s
    ``encode``/``encode_leaf``/``missing``/``finish`` interface and zero wire
    statistics shaped like the domain's formats.

    The ranks' leaves are summed in rank order into one sum tree (the first
    held rank's copied: the caller measures and drops each rank's gradients
    once encoded), so it holds one fp32 tree where the wire held its int8
    payload of n ranks — the same bytes at n = 4.  On a process group each
    leaf's sum then goes through an fp32 ``all_reduce``.  The sum is divided
    by ``n`` held as a tensor, a division as the reference's ``pmean`` makes
    (CUDA's division by a Python number multiplies by its reciprocal).

    ``part`` (a ZeRO-1 partitioner of the tree): the sharded fallback, the
    reference's exact ``psum_scatter(part.flatten(grads)) / n``.  The sum
    tree is kept in fp32 (the reference flattens to fp32 before it sums),
    and :meth:`owner_segments` gives owner row ``i`` its shard of the mean,
    one segment per bucket of the layout, made when asked for (the caller
    holds one owner's shard at a time).  On a process group the whole sum
    tree is all-reduced, leaf by leaf, in place.
    """

    def __init__(self, like, formats, transport, *,
                 domain: str = "wire_grads", part=None):
        self.stat_shape = tuple(resolve_domain_format(formats, domain)
                                .il.shape)
        self.transport, self.part = transport, part
        self.rows = list(transport.ranks)
        self.skeleton = tree_lib.map_tree(lambda _: None, like)
        leaves = tree_lib.leaves(like)
        self.device = leaves[0].device
        self.sum = [None] * len(leaves)
        self.seen = [[] for _ in leaves]
        self.reduced = False

    def encode_leaf(self, rank: int, g: int, leaf: torch.Tensor):
        """Add ``rank``'s leaf ``g`` to its sum (the ranks in order)."""
        with torch.no_grad():
            if self.sum[g] is None:
                self.sum[g] = (leaf.to(torch.float32, copy=True)
                               if self.part is not None else leaf.clone())
            else:
                self.sum[g].add_(leaf)
        self.seen[g].append(rank)

    def encode(self, rank: int, tree) -> QuantStats:
        for g, leaf in enumerate(tree_lib.leaves(tree)):
            self.encode_leaf(rank, g, leaf)
        return QuantStats.zero(self.stat_shape, self.device)

    def missing(self, rank: int) -> List[int]:
        """Leaves ``rank`` has not added yet."""
        return [g for g, seen in enumerate(self.seen) if rank not in seen]

    @property
    def stats(self) -> List[QuantStats]:
        return [QuantStats.zero(self.stat_shape, self.device)
                for _ in self.rows]

    def _summed(self):
        """The sum tree over the whole axis (checked, then all-reduced on a
        process group, once)."""
        if self.reduced:
            return self.sum
        if any(seen != self.rows for seen in self.seen):
            raise RuntimeError(f"encoded ranks {self.seen}, the transport "
                               f"holds {self.rows} (in that order)")
        if len(self.rows) != self.transport.axis_size:
            with torch.no_grad():
                self.sum = [self.transport.psum(s[None]) for s in self.sum]
        self.reduced = True
        return self.sum

    def _n(self, dtype):
        return torch.tensor(self.transport.axis_size, dtype=dtype,
                            device=self.device)

    def finish(self):
        """``(mean tree, zero stats per rank held)``."""
        out, self.sum = self._summed(), None
        with torch.no_grad():
            for s in out:
                s.div_(self._n(s.dtype))
        return tree_lib.from_leaves(self.skeleton, out), self.stats

    def owner_segments(self, i: int) -> List[torch.Tensor]:
        """Owner row ``i``'s fp32 shard of the mean (``part``), one segment
        per run of the layout: a new tensor on every call."""
        if self.part is None:
            raise ValueError("owner_segments needs the ZeRO partitioner")
        shard = self.part.shard_from_tree(
            tree_lib.from_leaves(self.skeleton, self._summed()), self.rows[i])
        shard.div_(self._n(torch.float32))
        return [shard[so:so + cnt] for _, so, cnt in
                self.part.segments(self.rows[i])]

    def owner_mean(self, i: int) -> torch.Tensor:
        """Owner row ``i``'s whole ``[shard_size]`` shard of the mean."""
        segs = self.owner_segments(i)
        return segs[0] if len(segs) == 1 else torch.cat(segs)


def dps_allreduce_mean_tree(trees: Sequence, formats, transport, seed: int,
                            *, mode: str = ROUND_STOCHASTIC,
                            backend: str = "auto", domain: str = "wire_grads",
                            quantum: Optional[int] = None,
                            onchip_prng: bool = True):
    """:func:`dps_allreduce_mean` over whole trees in ONE collective pair.

    ``trees``: one nested dict of tensors per rank the transport holds.
    Each leaf is encoded straight into its slot of one int8 payload; a
    ``[G]``-shaped format (G = leaf count) runs one ⟨IL, FL⟩ per leaf
    (per-layer wire formats).  Returns ``(mean tree, stats per rank
    held)``, every leaf cast back to its own dtype.  ``onchip_prng``: the
    bit source (module docstring).  See :class:`TreeAllReduce`.
    """
    if len(trees) != len(transport.ranks):
        raise ValueError(f"{len(trees)} trees for the "
                         f"{len(transport.ranks)} ranks this transport holds")
    tw = TreeAllReduce(trees[0], formats, transport, seed, mode=mode,
                       backend=backend, domain=domain, quantum=quantum,
                       onchip_prng=onchip_prng)
    for r, tree in zip(transport.ranks, trees):
        tw.encode(r, tree)
    return tw.finish()
