"""Grouped ⟨IL, FL⟩ wire encoder: Hopper kernel, wrapper, plain version.

Counterpart of ``dps_quant_group_wire_pallas`` in
``repro/kernels/dps_quant.py``.  The input is a *group-aligned* flat buffer
of ``T`` tiles of ``quantum`` elements (a tile never straddles groups); tile
``t`` is rounded on the grid of row ``tile_group[t]`` of a ``[G, 2]``
⟨IL, FL⟩ table and written as int8 grid integers saturated to [-128, 127];
the seven statistics land in ``[G, 7]`` (sums add, the max column maxes).

The kernel is ``csrc/dps_quant.cu``.  It takes any ``quantum >= 1``: the
(32, 128) int8 tile and the 4096-element quantum of the TPU kernel are facts
of that machine's tiling and are not carried over.  The TPU's on-chip random
bits variant is not ported yet: stochastic rounding takes a bits operand.

:func:`dps_quant_group_wire` launches the kernel for CUDA tensors and runs
:func:`dps_quant_group_wire_plain` for CPU tensors, and never the one in
place of the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fixed_point import (ROUND_NEAREST, ROUND_STOCHASTIC,
                                          FixedPointFormat, wire_quantize)
from repro_torch.kernels import _build

# stats accumulator layout (columns of the [G, N_STATS] matrix)
N_STATS = 7

# launches of the CUDA kernel by the wrapper (one per call, whatever the
# number of internal stages)
launch_count = 0


def _check(x, fmt_tab, tile_group, bits, mask, quantum):
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    if x.ndim != 1 or x.numel() % quantum:
        raise ValueError(f"group-aligned buffer of {tuple(x.shape)} elements "
                         f"is not a flat multiple of the quantum {quantum}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    tiles = x.numel() // quantum
    if fmt_tab.dtype != torch.int32 or fmt_tab.ndim != 2 or fmt_tab.shape[1] != 2:
        raise TypeError("fmt_tab must be int32 [G, 2]")
    if tile_group.dtype != torch.int32 or tuple(tile_group.shape) != (tiles,):
        raise TypeError(f"tile_group must be int32 [{tiles}]")
    if bits is not None and (bits.dtype not in (torch.int32, torch.uint32)
                             or bits.shape != x.shape):
        raise TypeError("bits must be int32/uint32 with x's shape")
    if mask is not None and (mask.dtype != torch.float32
                             or mask.shape != x.shape):
        raise TypeError("mask must be float32 with x's shape")
    for name, t in (("x", x), ("fmt_tab", fmt_tab), ("tile_group", tile_group),
                    ("bits", bits), ("mask", mask)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return tiles


def dps_quant_group_wire_plain(x: torch.Tensor, fmt_tab: torch.Tensor,
                               tile_group: torch.Tensor,
                               bits: Optional[torch.Tensor] = None,
                               mask: Optional[torch.Tensor] = None, *,
                               quantum: int, emit_stats: bool = True):
    """The kernel's function in plain PyTorch: ``wire_quantize`` with one
    format per tile (each tile takes its group's table row), then the
    per-tile statistics folded into their group rows as the kernel's second
    stage folds them."""
    tiles = _check(x, fmt_tab, tile_group, bits, mask, quantum)
    tg = tile_group.to(torch.int64)
    fmt = FixedPointFormat(fmt_tab[tg, 0], fmt_tab[tg, 1])
    shape = (tiles, quantum)
    wire, s = wire_quantize(
        x.reshape(shape), fmt,
        mode=ROUND_NEAREST if bits is None else ROUND_STOCHASTIC,
        bits=None if bits is None else bits.reshape(shape),
        mask=None if mask is None else mask.reshape(shape),
        compute_stats=emit_stats)
    if not emit_stats:
        return wire.reshape(-1), None
    stats = torch.zeros(fmt_tab.shape[0], N_STATS, dtype=torch.float32,
                        device=x.device)
    sums = torch.stack([s.count, s.nonzero, s.overflow, s.abs_err_sum,
                        s.rel_err_sum, s.abs_sum], dim=1)
    stats[:, :6].index_add_(0, tg, sums)
    stats[:, 6].scatter_reduce_(0, tg, s.max_abs, "amax")
    return wire.reshape(-1), stats


def _dps_quant_group_wire_cuda(x, fmt_tab, tile_group, bits, mask, *,
                               quantum, emit_stats):
    global launch_count
    tiles = _check(x, fmt_tab, tile_group, bits, mask, quantum)
    groups = fmt_tab.shape[0]
    lib = _build.load()
    wire = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
    partials = stats = None
    if emit_stats:
        partials = torch.empty(tiles, N_STATS, dtype=torch.float32,
                               device=x.device)
        stats = torch.empty(groups, N_STATS, dtype=torch.float32,
                            device=x.device)
    ptrs = [t.data_ptr() for t in (x, bits, mask, wire) if t is not None]
    vec = quantum % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    # the launch is asynchronous; PyTorch's allocator hands freed memory only
    # to later work on the same stream, so the kernel's buffers outlive it
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dps_group_wire_encode(
            x.data_ptr(), int(x.dtype == torch.bfloat16), fmt_tab.data_ptr(),
            tile_group.data_ptr(),
            bits.data_ptr() if bits is not None else None,
            mask.data_ptr() if mask is not None else None,
            wire.data_ptr(),
            partials.data_ptr() if emit_stats else None,
            stats.data_ptr() if emit_stats else None,
            tiles, quantum, groups, int(vec), stream)
    _build.check(lib, code, "dps_group_wire_encode")
    launch_count += 1
    return wire, stats


def dps_quant_group_wire(x: torch.Tensor, fmt_tab: torch.Tensor,
                         tile_group: torch.Tensor,
                         bits: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None, *,
                         quantum: int, emit_stats: bool = True,
                         backend: str = "auto"):
    """Per-group ⟨IL, FL⟩ wire encode of a group-aligned flat buffer.

    ``x``: flat fp32/bf16 buffer of ``T · quantum`` elements.  ``fmt_tab``:
    int32 ``[G, 2]`` rows of ``[IL, FL]``.  ``tile_group``: int32 ``[T]``
    mapping tile → table row.  ``bits``: 32 random bits per element for
    stochastic rounding, or ``None`` to round to nearest.  ``mask``: float32
    1/0 per element, zeroing padding out of the wire and the statistics, or
    ``None``.

    Returns ``(wire int8 [T·quantum], stats float32 [G, 7] | None)``.  Wire
    bytes and the integer-valued statistics equal the plain version's bit
    for bit; the three float sums agree to summation order.

    ``backend``: ``"auto"`` launches the CUDA kernel for a CUDA tensor and
    runs the plain version for a CPU tensor; ``"kernel"`` raises for a CPU
    tensor; ``"plain"`` runs the plain version wherever the tensor lies.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown encode backend {backend!r}")
    if backend == "plain" or (backend == "auto" and not x.is_cuda):
        return dps_quant_group_wire_plain(x, fmt_tab, tile_group, bits, mask,
                                          quantum=quantum,
                                          emit_stats=emit_stats)
    if not x.is_cuda:
        raise ValueError("backend='kernel' needs a CUDA tensor: the grouped "
                         "wire encoder is a CUDA kernel")
    return _dps_quant_group_wire_cuda(x, fmt_tab, tile_group, bits, mask,
                                      quantum=quantum, emit_stats=emit_stats)
