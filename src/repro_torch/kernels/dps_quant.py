"""The DPS quantizer kernels: Hopper kernels, wrappers, plain versions.

Two functions of ``repro/kernels/dps_quant.py`` live here, both CUDA C++ in
``csrc/dps_quant.cu``:

* **K1 / K1b** — :func:`dps_quant`, counterpart of ``dps_quant_pallas``
  (``_kernel`` with ``emit_wire=False``): ``fixed_point.quantize`` and its
  seven statistics in one pass over a flat fp32/bf16 tensor of any size.
  K1 takes its stochastic-rounding bits as an operand (the reference's
  ``use_onchip_prng=False``); K1b draws them in the kernel from a
  Philox4x32-10 stream keyed on a 64-bit seed, element ``e`` taking word
  ``e % 4`` of counter ``e // 4`` (:func:`philox_bits` is the same stream in
  plain PyTorch), so K1b equals K1 fed ``philox_bits`` of the same seed.
  ⟨IL, FL⟩ are two int32 device scalars read by the kernel.
* **K3** — :func:`dps_quant_group_wire`, counterpart of
  ``dps_quant_group_wire_pallas``.  The input is a *group-aligned* flat
  buffer of ``T`` tiles of ``quantum`` elements (a tile never straddles
  groups); tile ``t`` is rounded on the grid of row ``tile_group[t]`` of a
  ``[G, 2]`` ⟨IL, FL⟩ table and written as int8 grid integers saturated to
  [-128, 127]; the seven statistics land in ``[G, 7]`` (sums add, the max
  column maxes).  It takes any ``quantum >= 1``: the (32, 128) int8 tile and
  the 4096-element quantum of the TPU kernel are facts of that machine's
  tiling and are not carried over.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
(:func:`dps_quant_plain`, :func:`dps_quant_group_wire_plain`) for CPU
tensors, and never the one in place of the other.  Each kernel has its own
launch counter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.fixed_point import (ROUND_NEAREST, ROUND_STOCHASTIC,
                                          FixedPointFormat, quantize,
                                          wire_quantize)
from repro_torch.kernels import _build

# stats accumulator layout (columns of the [G, N_STATS] matrix)
N_STATS = 7

# launches by the wrappers (one per call, whatever the number of internal
# stages): K3, K1 (nearest, or a bits operand), K1b (Philox in the kernel)
launch_count = 0
quantize_launch_count = 0
quantize_prng_launch_count = 0

# K1/K1b grid: 256 threads a block, four elements a thread per step, at most
# four blocks per SM of an H100; the grid is a function of the size alone
Q_THREADS = 256
Q_MAX_BLOCKS = 4 * 132
Q_PART = 6               # doubles per block in the statistics partials


# ---------------------------------------------------------------------------
# Philox4x32-10, the stream of K1b, in plain PyTorch.
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_LO32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values in the int64 tensor ``b``.  The product itself can
    pass 2^63, so ``hi`` is assembled from 16-bit halves; ``lo`` is the low
    word of the wrapped int64 product, which wrapping leaves intact."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    t = al * bl
    mid = ah * bl + al * bh + (t >> 16)
    return ah * bh + (mid >> 16), (a * b) & _LO32


def philox4x32_10(ctr: torch.Tensor, key) -> torch.Tensor:
    """Philox4x32-10 of the counters ``ctr`` (``[N, 4]`` int64 holding
    uint32 words, low word first) under the key ``(k0, k1)``: ``[N, 4]``
    int64 holding the uint32 output words."""
    c0, c1, c2, c3 = ctr.unbind(1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _LO32, (k1 + _W1) & _LO32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1)


def philox_bits(seed: int, n: int, device=None,
                chunk: int = 1 << 22) -> torch.Tensor:
    """The ``n`` words K1b draws for seed ``seed``, as int32 (the uint32
    bits reinterpreted): element ``e`` takes word ``e % 4`` of counter
    ``e // 4``.  Computed ``chunk`` counters at a time to bound the int64
    temporaries."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned integer, got {seed}")
    out = torch.empty(-(-n // 4) * 4, dtype=torch.int32, device=device)
    for c in range(0, out.numel() // 4, chunk):
        m = min(chunk, out.numel() // 4 - c)
        i = torch.arange(c, c + m, dtype=torch.int64, device=device)
        zero = torch.zeros_like(i)
        ctr = torch.stack([i & _LO32, i >> 32, zero, zero], dim=1)
        w = philox4x32_10(ctr, (seed & _LO32, seed >> 32)).reshape(-1)
        # uint32 -> int32 with the same bits
        out[4 * c:4 * (c + m)] = torch.where(w >= 1 << 31, w - (1 << 32),
                                             w).to(torch.int32)
    return out[:n]


@dataclasses.dataclass(frozen=True)
class Philox:
    """K1b's source of rounding bits: the stream :func:`philox_bits` gives
    for the 64-bit ``seed``, drawn inside the kernel."""

    seed: int

    def __post_init__(self):
        if not 0 <= self.seed < 1 << 64:
            raise ValueError(f"seed must be a 64-bit unsigned integer, got "
                             f"{self.seed}")


# ---------------------------------------------------------------------------
# K1 / K1b: the quantizer of the training path.
# ---------------------------------------------------------------------------

def quant_blocks(n: int) -> int:
    """The K1/K1b grid for ``n`` elements (also the partials' row count)."""
    return max(1, min(-(-max(n // 4, 1) // Q_THREADS), Q_MAX_BLOCKS))


def _check_quant(x, il, fl, bits, out):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("il", il), ("fl", fl)):
        if t.dtype != torch.int32 or t.numel() != 1:
            raise TypeError(f"{name} must be one int32, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if bits is not None and (bits.dtype not in (torch.int32, torch.uint32)
                             or bits.numel() != x.numel()):
        raise TypeError("bits must be int32/uint32 with x's size")
    if out is not None and (out.dtype != x.dtype or out.shape != x.shape):
        raise TypeError("out must have x's dtype and shape")
    for name, t in (("x", x), ("il", il), ("fl", fl), ("bits", bits),
                    ("out", out)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dps_quant_plain(x: torch.Tensor, il: torch.Tensor, fl: torch.Tensor,
                    bits: Optional[torch.Tensor] = None, *,
                    compute_stats: bool = True):
    """K1's function in plain PyTorch: ``fixed_point.quantize`` on x's grid
    ⟨il, fl⟩, stochastic with ``bits`` (32 per element) or to nearest when
    ``bits`` is None.  Returns ``(q, stats float32 [7] | None)``, the stats
    in the order count, nonzero, overflow, abs_err_sum, rel_err_sum,
    abs_sum, max_abs."""
    _check_quant(x, il, fl, bits, None)
    q, s = quantize(
        x, FixedPointFormat(il.reshape(()), fl.reshape(())),
        mode=ROUND_NEAREST if bits is None else ROUND_STOCHASTIC,
        bits=None if bits is None else bits.reshape(x.shape),
        compute_stats=compute_stats)
    if not compute_stats:
        return q, None
    return q, torch.stack([s.count, s.nonzero, s.overflow, s.abs_err_sum,
                           s.rel_err_sum, s.abs_sum, s.max_abs])


def _dps_quant_cuda(x, il, fl, bits, seed, src, compute_stats, out):
    global quantize_launch_count, quantize_prng_launch_count
    _check_quant(x, il, fl, bits, out)
    n = x.numel()
    lib = _build.load()
    q = torch.empty_like(x) if out is None else out
    nblocks = quant_blocks(n)
    partials = stats = None
    if compute_stats:
        partials = torch.empty(nblocks * Q_PART, dtype=torch.float64,
                               device=x.device)
        stats = torch.empty(N_STATS, dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, q, bits) if t is not None]
    vec = all(p % 16 == 0 for p in ptrs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dps_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), n, il.data_ptr(),
            fl.data_ptr(), bits.data_ptr() if bits is not None else None, src,
            seed, q.data_ptr(),
            partials.data_ptr() if compute_stats else None,
            stats.data_ptr() if compute_stats else None, nblocks, int(vec),
            stream)
    _build.check(lib, code, "dps_quantize")
    if src == 2:
        quantize_prng_launch_count += 1
    else:
        quantize_launch_count += 1
    return q, stats


def dps_quant(x: torch.Tensor, il: torch.Tensor, fl: torch.Tensor,
              bits: Union[None, torch.Tensor, Philox] = None, *,
              compute_stats: bool = True,
              out: Optional[torch.Tensor] = None, backend: str = "auto"):
    """Quantize ``x`` (fp32/bf16, contiguous, any shape) onto ⟨il, fl⟩.

    ``il``/``fl``: one int32 each, on x's device.  ``bits``, the rounding's
    source of bits: ``None`` rounds to nearest; an int32/uint32 tensor of
    x's size rounds stochastically with those 32 bits per element (K1); a
    :class:`Philox` rounds stochastically with its stream, drawn in the
    kernel (K1b).  ``out``: where to write q (x's dtype and shape; x itself
    is allowed).  Returns ``(q, stats float32 [7] | None)``; q equals the
    plain version's bit for bit, ``count``/``nonzero``/``overflow``/
    ``max_abs`` exactly (counts past 2^24 to the rounding of the final
    float32), the three float sums to summation order.

    ``backend``: ``"auto"`` launches the kernel for a CUDA tensor and runs
    the plain version for a CPU tensor; ``"kernel"`` raises for a CPU
    tensor; ``"plain"`` runs the plain version wherever the tensor lies.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown quantize backend {backend!r}")
    if not (bits is None or isinstance(bits, (torch.Tensor, Philox))):
        raise TypeError("bits must be None (nearest), a tensor of bits or a "
                        f"Philox stream, got {type(bits).__name__}")
    if backend == "plain" or (backend == "auto" and not x.is_cuda):
        if isinstance(bits, Philox):
            bits = philox_bits(bits.seed, x.numel(), x.device)
        q, stats = dps_quant_plain(x, il, fl, bits,
                                   compute_stats=compute_stats)
        if out is not None:
            out.copy_(q)
            q = out
        return q, stats
    if not x.is_cuda:
        raise ValueError("backend='kernel' needs a CUDA tensor: the "
                         "quantizer is a CUDA kernel")
    if isinstance(bits, Philox):
        return _dps_quant_cuda(x, il, fl, None, bits.seed, 2, compute_stats,
                               out)
    return _dps_quant_cuda(x, il, fl, bits, 0, 0 if bits is None else 1,
                           compute_stats, out)


# ---------------------------------------------------------------------------
# K3: the grouped wire encoder of the serving path.
# ---------------------------------------------------------------------------

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
