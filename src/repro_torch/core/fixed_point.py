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
from typing import Optional

import torch

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
        stats = QuantStats(
            count=torch.tensor(float(x.numel()), **f32),
            nonzero=(abs_ref > 0.0).to(torch.float32).sum(),
            overflow=over.to(torch.float32).sum(),
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
    and zeroes the corresponding wire bytes.

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

    xf, over_range, yc, q_int, inv_scale = _grid_round(x, fmt_b, mode, bits,
                                                       generator, compute_stats)
    sat = torch.clamp(q_int, WIRE_QMIN, WIRE_QMAX)
    wire = (sat if mask is None else sat * mask.to(torch.float32)).to(torch.int8)

    stats = None
    if compute_stats:
        m = (torch.ones(x.shape, dtype=torch.float32, device=x.device)
             if mask is None else mask.to(torch.float32))
        over = (over_range | (q_int != sat)).to(torch.float32) * m
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
            count=rsum(m),
            nonzero=rsum((abs_ref > 0.0).to(torch.float32)),
            overflow=rsum(over),
            abs_err_sum=rsum(abs_err),
            rel_err_sum=rsum(_rel_err(abs_err, abs_ref)),
            abs_sum=rsum(abs_ref),
            max_abs=max_abs,
        )
    return wire, stats
