"""Dynamic fixed-point ⟨IL, FL⟩ emulation with fused quantization statistics.

Counterpart of ``repro/core/fixed_point.py``.  A fixed-point format is a
pair of bit-widths ``⟨IL, FL⟩``: IL integer bits (including sign) and FL
fractional bits.  The representable grid is ``k · 2^-FL`` for integers
``k ∈ [-2^(IL-1+FL), 2^(IL-1+FL) - 1]``.

IL and FL are **int32 tensors**, never Python ints, so a controller can
change them every step on the device without a host round trip.  All scale
factors are built from exponent bits (:func:`exp2_int`), never ``exp2`` or
``2.0 ** n``: an inexact power of two would knock every value off the grid.

Exactness: emulation math runs in float32.  Grid integers are exact in
float32 iff ``IL - 1 + FL <= 24``; controllers clamp widths to honour this.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional

import torch

from repro_torch.core import tree as tree_lib

# Stochastic-rounding uniforms are exact multiples of 2^-24 (fp32 mantissa).
_U_BITS = 24
_U_SCALE = 1.0 / (1 << _U_BITS)

ROUND_NEAREST = "nearest"
ROUND_STOCHASTIC = "stochastic"

# Capacity of the int8 wire payload: grid integers outside [-128, 127]
# saturate (and are counted as overflow).
WIRE_QMIN = -128.0
WIRE_QMAX = 127.0


def _i32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32)
    return torch.as_tensor(v, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """A (possibly batched) dynamic fixed-point format.

    ``il``/``fl`` are int32 tensors: 0-d for global granularity, shape
    ``[G]`` for per-group granularity.
    """

    il: torch.Tensor
    fl: torch.Tensor

    @staticmethod
    def create(il: int, fl: int, device=None) -> "FixedPointFormat":
        return FixedPointFormat(_i32(il, device), _i32(fl, device))

    def total_bits(self) -> torch.Tensor:
        return self.il + self.fl


@dataclasses.dataclass(frozen=True)
class QuantStats:
    """Sufficient statistics of one quantization event.

    All fields are sums/counts (or max for ``max_abs``) so they combine
    across tensors, layers and shards without bias.
    """

    count: torch.Tensor          # f32, number of elements
    nonzero: torch.Tensor        # f32, elements with |x| > 0
    overflow: torch.Tensor       # f32, elements clipped at the range boundary
    abs_err_sum: torch.Tensor    # f32, Σ |q - clip(x)| (rounding error only)
    rel_err_sum: torch.Tensor    # f32, Σ |q - clip(x)| / |clip(x)| over nonzero
    abs_sum: torch.Tensor        # f32, Σ |clip(x)|
    max_abs: torch.Tensor        # f32, max |x| (pre-clip)

    @staticmethod
    def zero(shape=(), device=None) -> "QuantStats":
        return QuantStats(*(torch.zeros(shape, dtype=torch.float32,
                                        device=device) for _ in range(7)))

    def merge(self, other: "QuantStats") -> "QuantStats":
        return QuantStats(
            self.count + other.count,
            self.nonzero + other.nonzero,
            self.overflow + other.overflow,
            self.abs_err_sum + other.abs_err_sum,
            self.rel_err_sum + other.rel_err_sum,
            self.abs_sum + other.abs_sum,
            torch.maximum(self.max_abs, other.max_abs),
        )

    # --- derived metrics (paper §2.2) ---
    def overflow_rate(self) -> torch.Tensor:
        """R: fraction of values that clipped — drives IL."""
        return self.overflow / self.count.clamp(min=1.0)

    def quant_error(self, metric: str = "relative_mean") -> torch.Tensor:
        """E: average quantization error percentage — drives FL.

        ``relative_mean``: mean over nonzero elements of |q-x|/|x|;
        ``ratio``: Σ|q-x| / Σ|x|.
        """
        if metric == "relative_mean":
            return self.rel_err_sum / self.nonzero.clamp(min=1.0)
        if metric == "ratio":
            return self.abs_err_sum / self.abs_sum.clamp(min=1e-30)
        raise ValueError(f"unknown error metric {metric!r}")


def merge_stats(*stats: QuantStats) -> QuantStats:
    out = stats[0]
    for s in stats[1:]:
        out = out.merge(s)
    return out


# ---------------------------------------------------------------------------
# Seeds: the counterpart of jax.random.fold_in for 64-bit integer seeds.
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed: int, *data) -> int:
    """A new 64-bit seed from ``seed`` and each of ``data`` in turn (ints,
    or strings hashed with CRC-32 as the reference hashes its string
    salts).  A pure host-side function: a quantization event's seed costs
    no device work, and a recomputed forward gets the same seed again."""
    h = seed & _MASK64
    for d in data:
        if isinstance(d, str):
            d = zlib.crc32(d.encode())
        h = _splitmix64(h ^ _splitmix64(int(d) & _MASK64))
    return h


def exp2_int(n: torch.Tensor) -> torch.Tensor:
    """Bit-exact ``2.0 ** n`` for int32 ``n`` in [-126, 127].

    The float32 is assembled from its exponent bits, which is exact by
    definition on every device.
    """
    n = _i32(n).clamp(-126, 127)
    return ((n + 127) << 23).view(torch.float32)


def grid_bounds(fmt: FixedPointFormat):
    """Scale factors and integer-grid bounds for a format."""
    scale = exp2_int(fmt.fl)             # x -> grid units
    inv_scale = exp2_int(-fmt.fl)        # grid units -> x
    span = exp2_int(fmt.il - 1 + fmt.fl)
    qmax = span - 1.0                    # largest grid integer
    qmin = -span                         # smallest grid integer
    return scale, inv_scale, qmin, qmax


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (uint32 or int32 storage) -> exact fp32 uniforms in
    [0, 1) on the 2^-24 grid.  The top 24 bits are taken with a logical
    shift: arithmetic shift on the int32 view, then a mask."""
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    elif bits.dtype != torch.int32:
        raise TypeError(f"rounding bits must be uint32 or int32, got {bits.dtype}")
    top = (bits >> (32 - _U_BITS)) & ((1 << _U_BITS) - 1)
    return top.to(torch.float32) * _U_SCALE


def _grid_round(x: torch.Tensor, fmt_b: FixedPointFormat, mode: str,
                bits: Optional[torch.Tensor],
                generator: Optional[torch.Generator], want_over: bool = True):
    """Shared grid-rounding core of :func:`quantize` / :func:`wire_quantize`.

    Returns ``(xf, over_range, yc, q_int, inv_scale)`` where ``q_int`` is
    the rounded grid integer clipped to the ⟨IL, FL⟩ range and ``yc`` the
    range-clipped value in grid units.  ``over_range`` is ``None`` unless
    ``want_over`` (only the statistics read it).
    """
    xf = x.to(torch.float32)
    scale, inv_scale, qmin, qmax = grid_bounds(fmt_b)

    y = xf * scale
    over_range = ((y > qmax) | (y < qmin)) if want_over else None
    yc = torch.clamp(y, qmin, qmax)

    if mode == ROUND_STOCHASTIC:
        if bits is None:
            if generator is None:
                raise ValueError("stochastic rounding needs `bits` or `generator`")
            bits = torch.randint(-2**31, 2**31, x.shape, dtype=torch.int32,
                                 device=x.device, generator=generator)
        q_int = torch.floor(yc + _uniform_from_bits(bits))
    elif mode == ROUND_NEAREST:
        # round half up (floor(y + 0.5)), not torch.round's half-to-even
        q_int = torch.floor(yc + 0.5)
    else:
        raise ValueError(f"unknown rounding mode {mode!r}")
    q_int = torch.clamp(q_int, qmin, qmax)
    return xf, over_range, yc, q_int, inv_scale


def _rel_err(abs_err: torch.Tensor, abs_ref: torch.Tensor) -> torch.Tensor:
    nz = abs_ref > 0.0
    return torch.where(nz, abs_err / torch.where(nz, abs_ref, 1.0), 0.0)


def quantize(
    x: torch.Tensor,
    fmt: FixedPointFormat,
    *,
    mode: str = ROUND_STOCHASTIC,
    bits: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    compute_stats: bool = True,
):
    """Quantize ``x`` onto the ⟨IL, FL⟩ grid.  Returns ``(q, stats | None)``.

    ``mode='stochastic'`` is the paper's Eq. (2): unbiased rounding with
    either ``bits`` (32 random bits per element, the deterministic path) or
    a ``generator`` to draw them.  ``mode='nearest'`` is Eq. (1),
    ``floor(y + 0.5)``.  ``q`` has x's dtype; internal math is fp32.  Stats
    measure *rounding* error against the range-clipped reference; overflow
    is reported separately (R -> IL, E -> FL).
    """
    xf, over, yc, q_int, inv_scale = _grid_round(x, fmt, mode, bits, generator,
                                                 compute_stats)
    q = q_int * inv_scale

    stats = None
    if compute_stats:
        x_ref = yc * inv_scale           # range-clipped reference value
        abs_err = (q - x_ref).abs()
        abs_ref = x_ref.abs()
        f32 = dict(dtype=torch.float32, device=x.device)
        # counts summed as integers, then rounded once: exact up to 2^24
        # like the reference's float32 sums, and correctly rounded past it
        stats = QuantStats(
            count=torch.tensor(float(x.numel()), **f32),
            nonzero=(abs_ref > 0.0).sum().to(torch.float32),
            overflow=over.sum().to(torch.float32),
            abs_err_sum=abs_err.sum(),
            rel_err_sum=_rel_err(abs_err, abs_ref).sum(),
            abs_sum=abs_ref.sum(),
            max_abs=xf.abs().max() if x.numel() else torch.zeros((), **f32),
        )
    return q.to(x.dtype), stats


def wire_quantize(
    x: torch.Tensor,
    fmt: FixedPointFormat,
    *,
    mode: str = ROUND_STOCHASTIC,
    bits: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    compute_stats: bool = True,
    mask: Optional[torch.Tensor] = None,
):
    """Quantize ``x`` onto the ⟨IL, FL⟩ grid and emit int8 *grid integers*.

    The wire payload is ``round(q · 2^FL)`` saturated at ``[-128, 127]``.
    For IL + FL ≤ 8 the grid fits the wire exactly; for over-wide formats
    the saturated elements are counted into ``stats.overflow`` and the
    rounding error is measured against the *decoded wire value*.

    Per-group formats: when ``fmt.il``/``fmt.fl`` have shape ``[G]`` (or any
    non-scalar shape), the leading ``fmt.il.ndim`` dims of ``x`` must equal
    it; stats reduce over the remaining trailing dims, so every stats leaf
    comes out with shape ``fmt.il.shape``.

    ``mask`` (same shape as x, 1/0) excludes padding from the statistics
    and zeroes the corresponding wire bytes.  A NaN in x is written as the
    byte 0 (as XLA's and the kernels' float -> int8 conversions give it) and
    counted as overflow.  Counts are summed as integers.

    Returns ``(wire int8 with x's shape, stats | None)``.
    """
    nd = fmt.il.ndim
    if x.ndim < nd or tuple(x.shape[:nd]) != tuple(fmt.il.shape):
        raise ValueError(
            f"per-group format {tuple(fmt.il.shape)} needs x leading dims to "
            f"match, got x shape {tuple(x.shape)}")
    bshape = tuple(fmt.il.shape) + (1,) * (x.ndim - nd)
    fmt_b = FixedPointFormat(fmt.il.reshape(bshape), fmt.fl.reshape(bshape))
    axes = tuple(range(nd, x.ndim))

    def rsum(v):
        return v.sum(dim=axes) if axes else v

    def rcount(b):
        return rsum(b.to(torch.int64)).to(torch.float32)

    xf, over_range, yc, q_int, inv_scale = _grid_round(x, fmt_b, mode, bits,
                                                       generator, compute_stats)
    sat = torch.clamp(q_int, WIRE_QMIN, WIRE_QMAX)
    wire = torch.nan_to_num(sat if mask is None
                            else sat * mask.to(torch.float32),
                            nan=0.0).to(torch.int8)

    stats = None
    if compute_stats:
        m = (torch.ones(x.shape, dtype=torch.float32, device=x.device)
             if mask is None else mask.to(torch.float32))
        keep = m != 0.0
        over = (over_range | (q_int != sat)) & keep
        x_ref = yc * inv_scale              # range-clipped reference value
        dec = sat * inv_scale               # what the receiver will decode
        abs_err = (dec - x_ref).abs() * m
        abs_ref = x_ref.abs() * m
        if x.numel() and axes:
            max_abs = (xf.abs() * m).amax(dim=axes)
        elif x.numel():
            max_abs = xf.abs() * m
        else:
            max_abs = torch.zeros(tuple(fmt.il.shape), dtype=torch.float32,
                                  device=x.device)
        stats = QuantStats(
            count=rcount(keep),
            nonzero=rcount(abs_ref > 0.0),
            overflow=rcount(over),
            abs_err_sum=rsum(abs_err),
            rel_err_sum=rsum(_rel_err(abs_err, abs_ref)),
            abs_sum=rsum(abs_ref),
            max_abs=max_abs,
        )
    return wire, stats


def quantize_tree(tree, fmt: FixedPointFormat, *, mode: str = ROUND_STOCHASTIC,
                  seed: int = 0, predicate=None, onchip_prng: bool = False,
                  backend: str = "auto", inplace: bool = False):
    """Quantize every selected leaf of a nested dict with one shared format.

    ``predicate(path, leaf) -> bool`` selects the leaves (see
    :mod:`repro_torch.core.policy`); the others are returned as they are.
    Leaf ``i`` (sorted-key order, as the reference flattens) rounds with
    the seed ``fold_seed(seed, i)``.  Every event goes through the fused
    quantizer (:func:`repro_torch.kernels.ops.dps_quantize`): the kernel on
    a CUDA tensor, its plain version on the CPU.  ``inplace`` writes each
    selected leaf's q over the leaf itself (the train step's re-snap and
    gradient quantization: a second copy of 3.2 B fp32 values would not
    fit beside the rest).  Returns ``(tree_q, merged QuantStats)``.
    """
    out, stats = [], []
    for i, (path, leaf) in enumerate(tree_lib.leaves_with_path(tree)):
        q, s = quantize_tree_leaf(i, path, leaf, fmt, mode=mode, seed=seed,
                                  predicate=predicate,
                                  onchip_prng=onchip_prng, backend=backend,
                                  inplace=inplace)
        out.append(q)
        if s is not None:
            stats.append(s)
    return tree_lib.from_leaves(tree, out), merge_tree_stats(stats, fmt)


def quantize_tree_leaf(i: int, path, leaf, fmt: FixedPointFormat, *,
                       mode: str = ROUND_STOCHASTIC, seed: int = 0,
                       predicate=None, onchip_prng: bool = False,
                       backend: str = "auto", inplace: bool = False):
    """Leaf ``i`` (at ``path``) of :func:`quantize_tree`, on its own: for a
    caller that has the leaves one at a time (the overlapped wire measures
    each gradient leaf as the backward produces it).  Returns ``(q,
    QuantStats)``, or ``(leaf, None)`` for a leaf the predicate skips;
    :func:`merge_tree_stats` of the stats in leaf order is
    :func:`quantize_tree`'s."""
    from repro_torch.kernels import ops           # ops imports this module
    if predicate is not None and not predicate(path, leaf):
        return leaf, None
    return _quantize_leaf(ops, leaf, fmt, mode, fold_seed(seed, i),
                          onchip_prng, backend, leaf if inplace else None)


def merge_split_stats(vecs, spec, mesh):
    """Statistics vectors ``[7]`` (one per held rank, of its block of a
    tensor laid out by ``spec``) merged over the axes the tensor is split
    on: counts and float sums summed in rank order, ``max_abs`` maxed.
    Every held rank gets the whole tensor's statistics; the axes it is
    replicated on are not summed over (each rank's block there is the
    same).  Outside autograd."""
    from repro_torch.dist import sharding          # dist imports core
    axes = [a for a in sharding.spec_axes(spec)
            if sharding._axis_sizes(mesh)[a] > 1]
    if not axes:
        return list(vecs)
    with torch.no_grad():
        sums = sharding.psum(mesh, axes, [v[:6] for v in vecs])
        maxes = sharding.pmax(mesh, axes, [v[6:] for v in vecs])
    return [torch.cat([a, b]) for a, b in zip(sums, maxes)]


def quantize_placed(i: int, path, leaf, fmt: FixedPointFormat, *,
                    mode: str = ROUND_STOCHASTIC, seed: int = 0,
                    predicate=None, onchip_prng: bool = False,
                    backend: str = "auto", inplace: bool = False,
                    keep=None):
    """:func:`quantize_tree_leaf` on a placed leaf
    (:class:`~repro_torch.dist.sharding.Placed`): each distinct block held
    rounds with the bits the whole leaf's event gives its elements (K1b in
    block mode, or the slice of the whole operand; a layer-stacked leaf
    that the replicated step draws layer by layer is drawn the same way),
    and the statistics are merged over the leaf's split axes.  ``keep`` (a
    bool device scalar, with ``inplace``): each block is snapped beside
    itself, one block at a time, and selected into it where ``keep``
    holds (the guards' skip gate).  Returns ``(placed q, QuantStats)`` or
    ``(leaf, None)``."""
    from repro_torch.dist.sharding import Placed
    from repro_torch.kernels import ops, ref as ref_lib
    if predicate is not None and not predicate(path, leaf):
        return leaf, None
    seed = fold_seed(seed, i)
    by_layer = (mode == ROUND_STOCHASTIC and not onchip_prng
                and leaf.ndim >= 3 and leaf.shape[0] > 4
                and math.prod(leaf.shape) > (1 << 22))
    qs, vecs = {}, {}
    for r, blk in leaf.distinct():
        origin, shape = leaf.geometry(r)
        out = blk if inplace and keep is None else torch.empty_like(blk)
        if by_layer:
            parts = []
            for layer in range(shape[0]):
                bits = ops.block_event_bits(
                    leaf.shape[1:], origin[1:], shape[1:], mode,
                    fold_seed(seed, origin[0] + layer), False, blk.device)
                parts.append(ops.dps_quantize(blk[layer], fmt, bits,
                                              out=out[layer],
                                              backend=backend)[1])
            st = merge_stats(*parts)
        else:
            bits = ops.block_event_bits(leaf.shape, origin, shape, mode, seed,
                                        onchip_prng, blk.device)
            _, st = ops.dps_quantize(blk, fmt, bits, out=out,
                                     backend=backend)
        if keep is not None:
            torch.where(keep, out, blk, out=blk)
            out = blk
        qs[id(blk)] = out
        vecs[id(blk)] = torch.stack([st.count, st.nonzero, st.overflow,
                                     st.abs_err_sum, st.rel_err_sum,
                                     st.abs_sum, st.max_abs])
    merged = merge_split_stats([vecs[id(b)] for b in leaf.blocks], leaf.spec,
                               leaf.mesh)
    q = Placed([qs[id(b)] for b in leaf.blocks], leaf.spec, leaf.mesh,
               leaf.shape)
    return q, ref_lib.stats_from_vector(merged[0])


def merge_tree_stats(stats, fmt: FixedPointFormat) -> QuantStats:
    """The selected leaves' stats, merged in leaf order (zero if none)."""
    return (merge_stats(*stats) if stats
            else QuantStats.zero(device=fmt.il.device))


def _quantize_leaf(ops, leaf, fmt, mode, seed, onchip_prng, backend, out):
    """One leaf.  With a bits operand, a layer-stacked leaf (ndim >= 3,
    more than 4 layers, above 2^22 elements) is drawn and quantized layer
    by layer, so the int32 bits are one layer's worth at a time, as the
    reference bounds its temporaries; the in-kernel generator needs no bits
    tensor, so one launch covers the leaf."""
    if (mode == ROUND_STOCHASTIC and not onchip_prng and leaf.ndim >= 3
            and leaf.shape[0] > 4 and leaf.numel() > (1 << 22)):
        q = torch.empty_like(leaf) if out is None else out
        stats = []
        for layer in range(leaf.shape[0]):
            x = leaf[layer]
            bits = ops.event_bits(x, mode, fold_seed(seed, layer), False)
            stats.append(ops.dps_quantize(x, fmt, bits, out=q[layer],
                                          backend=backend)[1])
        return q, merge_stats(*stats)
    return ops.dps_quantize(leaf, fmt,
                            ops.event_bits(leaf, mode, seed, onchip_prng),
                            out=out, backend=backend)
