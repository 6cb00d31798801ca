"""Caller-facing wrappers over the kernels (counterpart of
``repro/kernels/ops.py``): the quantizer (K1/K1b), the wire quantizer
(K2/K2b), the grouped wire encode (K3/K3b) and the fused wire reduce (K4)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.fixed_point import (ROUND_NEAREST, ROUND_STOCHASTIC,
                                          FixedPointFormat)
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels import dps_quant as dq
from repro_torch.kernels.dps_quant import (GroupPhilox, Philox, dps_quant,
                                           dps_quant_group_wire,
                                           dps_quant_wire)


def event_bits(x: torch.Tensor, mode: str, seed: int, onchip_prng: bool):
    """The rounding bits of one quantization event on ``x``, as
    :func:`dps_quantize` takes them: ``None`` under nearest rounding; under
    stochastic rounding ``Philox(seed)``, drawn inside the kernel (K1b), with
    ``onchip_prng``, else 32 bits per element drawn by ``torch.randint`` from
    a generator seeded with ``seed`` on x's device (K1's operand)."""
    if mode == ROUND_NEAREST:
        return None
    if mode != ROUND_STOCHASTIC:
        raise ValueError(f"unknown rounding mode {mode!r}")
    if onchip_prng:
        return Philox(seed)
    return operand_bits(seed, x.numel(), x.device)


def operand_bits(seed: int, n: int, device) -> torch.Tensor:
    """``n`` words of 32 random bits (int32) drawn by ``torch.randint`` from
    a generator seeded with ``seed`` on ``device``: the bits operand of K1,
    K2 and K3."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                         device=device, generator=gen)


def _scalar_fmt(fmt: FixedPointFormat, what: str):
    if fmt.il.numel() != 1 or fmt.fl.numel() != 1:
        raise ValueError(f"{what} takes one global format; per-group "
                         "formats go through dps_quantize_wire_grouped")


def dps_quantize(x: torch.Tensor, fmt: FixedPointFormat,
                 bits: Union[None, torch.Tensor, Philox] = None, *,
                 compute_stats: bool = True,
                 out: Optional[torch.Tensor] = None, backend: str = "auto"):
    """Fused quantize + statistics for a tensor of any rank (K1 / K1b).

    ``fmt``: a global format (0-d int32 ``il``/``fl`` on x's device).
    ``bits``: ``None`` (round to nearest), 32 bits per element (int32 or
    uint32 storage; K1) or a :class:`Philox` stream (K1b), as
    :func:`event_bits` makes them.  The kernel walks the flat tensor itself,
    ragged tail included: no fold, pad or mask copies.  Returns ``(q with
    x's dtype and shape, QuantStats | None)``.
    """
    _scalar_fmt(fmt, "dps_quantize")
    if isinstance(bits, torch.Tensor):
        bits = bits.contiguous()
    q, vec = dps_quant(x.contiguous(), fmt.il, fmt.fl, bits,
                       compute_stats=compute_stats, out=out, backend=backend)
    return q, (ref_lib.stats_from_vector(vec) if compute_stats else None)


def dps_quantize_wire(x: torch.Tensor, fmt: FixedPointFormat,
                      bits: Union[None, torch.Tensor, Philox] = None, *,
                      compute_stats: bool = True,
                      out: Optional[torch.Tensor] = None,
                      backend: str = "auto"):
    """Fused quantize → int8 wire payload + stats for a tensor of any rank,
    in one read-x/write-wire pass (K2, or K2b with a :class:`Philox`
    source).  ``out`` (int8, x's shape) may be a slice of a larger payload.
    Returns ``(wire int8 with x's shape, QuantStats | None)``; the bytes
    equal ``ref.dps_quant_wire_ref``'s, int8 saturation of over-wide formats
    counted into ``stats.overflow``."""
    _scalar_fmt(fmt, "dps_quantize_wire")
    if isinstance(bits, torch.Tensor):
        bits = bits.contiguous()
    w, vec = dps_quant_wire(x.contiguous(), fmt.il, fmt.fl, bits,
                            compute_stats=compute_stats, out=out,
                            backend=backend)
    return w, (ref_lib.stats_from_vector(vec) if compute_stats else None)


def format_table(fmt: FixedPointFormat) -> torch.Tensor:
    """A format as the kernels' int32 ``[G, 2]`` table (a global format is
    one row)."""
    return torch.stack([fmt.il.reshape(-1).to(torch.int32),
                        fmt.fl.reshape(-1).to(torch.int32)], dim=1).contiguous()


def dps_quantize_wire_grouped(x: torch.Tensor, fmt: FixedPointFormat,
                              tile_group: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              bits: Union[None, torch.Tensor, GroupPhilox] = None,
                              mask: Optional[torch.Tensor] = None,
                              stochastic: bool = True,
                              quantum: int,
                              compute_stats: bool = True,
                              out: Optional[torch.Tensor] = None,
                              backend: str = "auto"):
    """Fused per-group wire encode of a group-aligned flat buffer (K3, or
    K3b with a :class:`GroupPhilox` source).

    ``x`` is the group-aligned layout (``len(tile_group) · quantum``
    elements), ``fmt`` a ``[G]``-shaped format whose rows the tiles index
    via ``tile_group``.  ``mask`` (1/0 float32, same size) excludes
    alignment padding from the wire and the stats.  Stochastic rounding
    takes ``bits`` (32 per element, or a :class:`GroupPhilox` stream) or
    draws them from ``generator``.  Returns ``(wire int8 with x's size,
    [G]-shaped QuantStats | None)`` in one read-x/write-wire pass over
    device memory.
    """
    n = x.numel()
    if stochastic:
        if bits is None:
            if generator is None:
                raise ValueError("stochastic path needs `generator` or `bits`")
            bits = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                                 device=x.device, generator=generator)
        if isinstance(bits, torch.Tensor):
            bits = bits.reshape(-1)
    else:
        bits = None
    wire, mat = dps_quant_group_wire(
        x.reshape(-1), format_table(fmt), tile_group.to(torch.int32), bits,
        None if mask is None else mask.reshape(-1), quantum=quantum,
        emit_stats=compute_stats, out=out, backend=backend)
    return wire, (ref_lib.stats_from_matrix(mat) if compute_stats else None)


def dps_wire_reduce(wire: torch.Tensor, fmt: FixedPointFormat,
                    tile_group: Optional[torch.Tensor] = None, *,
                    quantum: int, backend: str = "auto") -> torch.Tensor:
    """Fused int8 decode → mean over the rank axis (the receive leg, K4).

    ``wire``: ``[n_ranks, chunk]`` int8, rows contiguous, any row stride.  A
    scalar ``fmt`` is a one-row table and decodes every tile with one FL
    (``tile_group`` ignored); a ``[G]`` format needs ``tile_group``
    (``ceil(chunk / quantum)`` entries) mapping this chunk's tiles into the
    table.  Returns the fp32 ``[chunk]`` mean without a decoded ``(n,
    chunk)`` fp32 intermediate in memory.
    """
    if fmt.il.ndim == 0:
        tile_group = None
    elif tile_group is None:
        raise ValueError("[G]-shaped formats need a tile_group map")
    else:
        tile_group = tile_group.to(torch.int32)
    return dq.dps_wire_reduce(wire, format_table(fmt), tile_group,
                              quantum=quantum, backend=backend)
