"""Oracles for the kernels under the signatures of ``repro/kernels/ref.py``.
Each is its kernel's plain PyTorch version, which lives beside the kernel."""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import (QuantStats, ROUND_NEAREST,
                                          ROUND_STOCHASTIC)


def dps_quant_group_wire_ref(x: torch.Tensor, il: torch.Tensor,
                             fl: torch.Tensor, tile_group: torch.Tensor,
                             bits, mask: torch.Tensor, quantum: int,
                             mode: str = ROUND_STOCHASTIC):
    """Oracle for the grouped wire kernel: ``(wire [L], stats [G, 7])``.

    ``x``/``bits``/``mask``: flat group-aligned buffers of ``T · quantum``
    elements; ``il``/``fl``: int32 ``[G]`` format table; ``tile_group``:
    int32 ``[T]``.  ``wire_quantize`` with a ``[T]``-shaped leading format
    followed by a segment reduction of the per-tile stats into the group
    rows — the kernel's plain version, under the reference's signature.
    """
    from repro_torch.kernels.dps_quant import dps_quant_group_wire_plain
    if mode not in (ROUND_STOCHASTIC, ROUND_NEAREST):
        raise ValueError(f"unknown rounding mode {mode!r}")
    fmt_tab = torch.stack([il.to(torch.int32), fl.to(torch.int32)], dim=1)
    return dps_quant_group_wire_plain(
        x.reshape(-1), fmt_tab, tile_group.to(torch.int32),
        bits.reshape(-1) if mode == ROUND_STOCHASTIC else None,
        mask.reshape(-1), quantum=quantum)


def paged_decode_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, fmt: torch.Tensor,
                          ptab: torch.Tensor, lens: torch.Tensor,
                          *, scale: float) -> torch.Tensor:
    """Oracle for paged decode attention: ``(B, H, Dh)`` fp32 out of int8
    (or fp32) KV page pools — one page dequantized per step, online
    softmax.  The kernel's plain version."""
    from repro_torch.kernels.paged_attn import paged_decode_attn_plain
    return paged_decode_attn_plain(q, k_pages, v_pages, fmt, ptab, lens,
                                   scale=scale)


def stats_from_matrix(mat: torch.Tensor) -> QuantStats:
    """``[G, 7]`` grouped-kernel accumulator → ``[G]``-shaped QuantStats."""
    return QuantStats(count=mat[:, 0], nonzero=mat[:, 1], overflow=mat[:, 2],
                      abs_err_sum=mat[:, 3], rel_err_sum=mat[:, 4],
                      abs_sum=mat[:, 5], max_abs=mat[:, 6])
