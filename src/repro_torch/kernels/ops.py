"""Caller-facing wrappers over the kernels (counterpart of
``repro/kernels/ops.py``; only the grouped wire encode is ported so far)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fixed_point import FixedPointFormat
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.dps_quant import dps_quant_group_wire


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
