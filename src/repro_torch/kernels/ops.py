"""Caller-facing wrappers over the kernels (counterpart of
``repro/kernels/ops.py``; the quantizer and the grouped wire encode are
ported, the wire quantizer and the fused wire reduce are not yet)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.fixed_point import (ROUND_NEAREST, ROUND_STOCHASTIC,
                                          FixedPointFormat)
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.dps_quant import (Philox, dps_quant,
                                           dps_quant_group_wire)


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
    gen = torch.Generator(device=x.device).manual_seed(seed % (1 << 63))
    return torch.randint(-2**31, 2**31, (x.numel(),), dtype=torch.int32,
                         device=x.device, generator=gen)


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
    if fmt.il.numel() != 1 or fmt.fl.numel() != 1:
        raise ValueError("dps_quantize takes one global format; per-group "
                         "formats go through dps_quantize_wire_grouped")
    if isinstance(bits, torch.Tensor):
        bits = bits.contiguous()
    q, vec = dps_quant(x.contiguous(), fmt.il, fmt.fl, bits,
                       compute_stats=compute_stats, out=out, backend=backend)
    return q, (ref_lib.stats_from_vector(vec) if compute_stats else None)


def dps_quantize_wire_grouped(x: torch.Tensor, fmt: FixedPointFormat,
                              tile_group: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              bits: Optional[torch.Tensor] = None,
                              mask: Optional[torch.Tensor] = None,
                              stochastic: bool = True,
                              quantum: int,
                              compute_stats: bool = True,
                              backend: str = "auto"):
    """Fused per-group wire encode of a group-aligned flat buffer.

    ``x`` is the group-aligned layout (``len(tile_group) · quantum``
    elements), ``fmt`` a ``[G]``-shaped format whose rows the tiles index
    via ``tile_group``.  ``mask`` (1/0 float32, same size) excludes
    alignment padding from the wire and the stats.  Stochastic rounding
    takes ``bits`` (32 per element) or draws them from ``generator``.
    Returns ``(wire int8 with x's size, [G]-shaped QuantStats | None)`` in
    one read-x/write-wire pass over device memory.
    """
    n = x.numel()
    if stochastic:
        if bits is None:
            if generator is None:
                raise ValueError("stochastic path needs `generator` or `bits`")
            bits = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                                 device=x.device, generator=generator)
        bits = bits.reshape(-1)
    else:
        bits = None
    fmt_tab = torch.stack([fmt.il.to(torch.int32), fmt.fl.to(torch.int32)],
                          dim=1).contiguous()
    wire, mat = dps_quant_group_wire(
        x.reshape(-1), fmt_tab, tile_group.to(torch.int32), bits,
        None if mask is None else mask.reshape(-1), quantum=quantum,
        emit_stats=compute_stats, backend=backend)
    return wire, (ref_lib.stats_from_matrix(mat) if compute_stats else None)
