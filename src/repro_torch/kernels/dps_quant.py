"""The DPS quantizer kernels: Hopper kernels, wrappers, plain versions.

The four functions of ``repro/kernels/dps_quant.py`` live here, all CUDA C++
in ``csrc/dps_quant.cu``:

* **K1 / K1b** — :func:`dps_quant`, counterpart of ``dps_quant_pallas``
  (``_kernel`` with ``emit_wire=False``): ``fixed_point.quantize`` and its
  seven statistics in one pass over a flat fp32/bf16 tensor of any size.
  K1 takes its stochastic-rounding bits as an operand (the reference's
  ``use_onchip_prng=False``); K1b draws them in the kernel from a
  Philox4x32-10 stream keyed on a 64-bit seed, element ``e`` taking word
  ``e % 4`` of counter ``e // 4`` (:func:`philox_bits` is the same stream in
  plain PyTorch), so K1b equals K1 fed ``philox_bits`` of the same seed.
  ⟨IL, FL⟩ are two int32 device scalars read by the kernel.
* **K2 / K2b** — :func:`dps_quant_wire`, counterpart of
  ``dps_quant_wire_pallas`` (``_kernel`` with ``emit_wire=True``): the same
  body writing the int8 wire payload (``fixed_point.wire_quantize``), with
  the same bit sources.
* **K3 / K3b** — :func:`dps_quant_group_wire`, counterpart of
  ``dps_quant_group_wire_pallas``.  The input is a *group-aligned* flat
  buffer of ``T`` tiles of ``quantum`` elements (a tile never straddles
  groups); tile ``t`` is rounded on the grid of row ``tile_group[t]`` of a
  ``[G, 2]`` ⟨IL, FL⟩ table and written as int8 grid integers saturated to
  [-128, 127]; the seven statistics land in ``[G, 7]`` (sums add, the max
  column maxes).  It takes any ``quantum >= 1``: the (32, 128) int8 tile and
  the 4096-element quantum of the TPU kernel are facts of that machine's
  tiling and are not carried over.  K3b draws its bits in the kernel, one
  Philox stream per group (:class:`GroupPhilox`).
* **K4** — :func:`dps_wire_reduce`, counterpart of
  ``dps_wire_reduce_pallas``: int8 ``[n, chunk]`` → fp32 ``[chunk]`` mean
  over the rows, each tile decoded with its table row's FL.  Two bodies:
  a ring of shared-memory stages filled by bulk copies (TMA), and a
  grid-stride body for what a bulk copy cannot take; :func:`reduce_plan`
  chooses, and ``reduce_tma_launch_count`` counts the TMA launches.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
(``*_plain``) for CPU tensors, and never the one in place of the other.  Each
kernel has its own launch counter.  While a
:class:`~repro_torch.analysis.trace.Trace` is open, each launch is also one
node of it, with its operands, results and geometry
(:class:`KernelCallGeometry`, built by the same builders that
:mod:`repro_torch.analysis.kernel_checks` holds a config's layouts to).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import tagging
from repro_torch.core.fixed_point import (ROUND_NEAREST, ROUND_STOCHASTIC,
                                          FixedPointFormat, exp2_int,
                                          fold_seed, quantize, wire_quantize)
from repro_torch.kernels import _build

# stats accumulator layout (columns of the [G, N_STATS] matrix)
N_STATS = 7

# launches by the wrappers (one per call, whatever the number of internal
# stages): K3 (nearest or a bits operand), K3b (Philox per group), K1 and K2
# (nearest or a bits operand), K1b and K2b (Philox in the kernel), K4
launch_count = 0
group_prng_launch_count = 0
quantize_launch_count = 0
quantize_prng_launch_count = 0
# the K1b launches in block mode (each also counted as a K1b launch above)
quantize_block_launch_count = 0
wire_launch_count = 0
wire_prng_launch_count = 0
reduce_launch_count = 0
reduce_tma_launch_count = 0      # the K4 launches that took the TMA body

# K1/K2's grid-stride body and K4's: 256 threads a block, at most four
# blocks per SM of an H100; the grid is a function of the size (and, for
# K1/K2, of whether statistics are taken) alone
Q_THREADS = 256
Q_MAX_BLOCKS = 4 * 132
Q_PART = 7               # doubles per block in K1/K2's statistics partials

# K1b's TMA body: 256 consumer threads and one producer warp a block, a ring
# of Q_STAGES stages of Q_STAGE_BYTES of x, at most two blocks an SM; a
# stage also takes Q_STAGE_META bytes of mbarriers and item header, and a
# plan at most Q_MAX_DYN_SMEM bytes
Q_TMA_THREADS = 288
Q_STAGE_BYTES = 16 << 10
Q_STAGES = 3
Q_TMA_BLOCKS = 2 * 132
Q_STAGE_META = 40
Q_MAX_DYN_SMEM = 200 << 10
# the fewest elements of a contiguous launch on the TMA body (see quant_plan)
Q_TMA_MIN = 1 << 24

# K4's TMA body: a stage holds 16 KB of rows, four stages a block, two
# blocks an SM (288 threads each), 227 KB of shared memory at most a block
RED_STAGE_BYTES = 16 << 10
RED_STAGES = 4
RED_BLOCKS = 2 * 132
RED_MAX_SMEM = 232448
# threads of K4's TMA block: eight consumer warps and one producer warp
RED_THREADS = 288

# K3/K3b: a persistent grid of at most G_BLOCKS blocks of Q_THREADS threads
# (four an SM, the kernel's launch bound; the library takes at most 1,024)
# over items of about G_ITEM_BYTES of x, at least
# G_MIN_ITEMS_A_BLOCK a block where the launch allows; with statistics, a
# run's partial row is G_PART doubles
G_BLOCKS = 4 * 132
G_ITEM_BYTES = 16 << 10
G_MIN_ITEMS_A_BLOCK = 4
G_PART = 8

# The grouped kernels' quantum must be a multiple of this many elements: K3
# and K4 move 16 int8 (one 16-byte vector) at a time, and K4's bulk copies
# take 16-byte multiples (repro_torch.dist.collectives.WIRE_CHUNK_ALIGN).
MIN_GROUP_QUANTUM = 16

# The grouped kernels' format table and tile -> group map are meant to stay
# tiny: a [G, 2] int32 table with thousands of rows signals a mis-built
# layout (the reference's budget; rule KG-SMEM-TABLE).
SMEM_TABLE_BUDGET_BYTES = 64 * 1024


# ---------------------------------------------------------------------------
# Launch geometry — what a wrapper launches, from Python ints alone, by the
# same plans (``quant_plan``, ``reduce_plan``) the wrapper launches by.
# While a trace is open each wrapper records its launch's geometry from
# these builders beside the values it passed (whose grid argument
# ``repro_torch.analysis.kernel_checks`` holds to the geometry's grid);
# the checks hold the same builders' geometry for a config's layouts
# (anywhere, no card needed).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCallGeometry:
    """One launch, described statically (or as a trace recorded it).

    ``kernel``: the library entry (a ``_build.KERNEL_SIGNATURES`` key);
    ``grid`` and ``threads``: blocks and threads a block; ``table_rows``: G
    of the ``[G, 2]`` format table; ``tile_group_len``: entries of the tile
    -> group map (the page table of K5); ``tiles``: quanta the launch
    covers; ``smem_bytes``: the dynamic shared memory a block asks for;
    ``args``: the values the call passed to the entry (a recorded launch
    only)."""

    kernel: str
    grid: Tuple[int, ...]
    threads: int
    out_dtype: str
    table_rows: Optional[int] = None
    tile_group_len: Optional[int] = None
    tiles: Optional[int] = None
    quantum: Optional[int] = None
    smem_bytes: int = 0
    args: Optional[tuple] = None

    @property
    def table_bytes(self) -> int:
        """int32 bytes of the format table and the tile -> group map."""
        return 4 * (2 * (self.table_rows or 0) + (self.tile_group_len or 0))

    @classmethod
    def from_launch(cls, node) -> "KernelCallGeometry":
        """The geometry a trace's launch node recorded."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(kernel=node.name, **{k: v for k, v in node.meta.items()
                                        if k in fields})


def quantize_call_geometry(size: int, *, wire: bool = False,
                           dtype: str = "float32", groups: int = 1,
                           block: bool = False,
                           plan: Optional["QuantPlan"] = None
                           ) -> KernelCallGeometry:
    """Geometry of a :func:`dps_quant` / :func:`dps_quant_wire` launch on a
    ``size``-element tensor of ``dtype`` (K1/K2; K1b/K2b launch the same
    grid; ``block``: K1b's block-mode entry) under ``plan`` (by default
    :func:`quant_plan`'s for a contiguous, 16-byte aligned tensor without a
    bits operand, the grid-stride body's thread taking ``groups`` groups of
    four elements: the library's ``dps_quant_groups_per_thread``)."""
    if plan is None:
        plan = quant_plan(size, x_bytes=2 if dtype == "bfloat16" else 4,
                          wire=wire, groups=groups)
    return KernelCallGeometry(
        kernel="dps_quantize_block" if block else "dps_quantize",
        grid=(plan.blocks,), threads=plan.threads,
        out_dtype="int8" if wire else dtype, smem_bytes=plan.smem_bytes)


def group_wire_call_geometry(total: int, n_groups: int, quantum: int,
                             tile_group_len: Optional[int] = None, *,
                             x_bytes: int = 4, src: int = 0,
                             stats: bool = False, aligned: bool = True
                             ) -> KernelCallGeometry:
    """Geometry of a :func:`dps_quant_group_wire` launch (K3/K3b) on a
    group-aligned ``total``-element buffer under a ``[G, 2]`` table and a
    tile map of ``tile_group_len`` entries (by default one a tile), on the
    grid :func:`group_plan` gives it (by default for fp32 x to nearest,
    without statistics, on 16-byte aligned buffers)."""
    tiles = total // quantum
    plan = group_plan(tiles, quantum, n_groups, x_bytes, src, stats, aligned)
    return KernelCallGeometry(
        kernel="dps_group_wire_encode", grid=(plan.blocks,),
        threads=plan.threads, out_dtype="int8", table_rows=n_groups,
        tile_group_len=tiles if tile_group_len is None else tile_group_len,
        tiles=tiles, quantum=quantum)


def wire_reduce_call_geometry(n_ranks: int, chunk: int, n_groups: int,
                              quantum: Optional[int],
                              plan: Optional["ReducePlan"] = None
                              ) -> KernelCallGeometry:
    """Geometry of a :func:`dps_wire_reduce` launch (K4) on an ``[n_ranks,
    chunk]`` payload under ``plan`` (by default :func:`reduce_plan`'s for
    rows ``n_ranks · chunk`` apart — a stacked all-to-all's received view —
    on 16-byte aligned buffers).  ``quantum=None``: a global format (a
    one-row table, no tile map; the wrapper's quantum is then the
    chunk)."""
    if plan is None:
        plan = reduce_plan(n_ranks, chunk, quantum or chunk,
                           n_ranks * chunk, True)
    tiles = -(-chunk // quantum) if quantum else None
    return KernelCallGeometry(
        kernel="dps_wire_reduce", grid=(plan.blocks,),
        threads=RED_THREADS if plan.body == "tma" else Q_THREADS,
        out_dtype="float32", table_rows=n_groups, tile_group_len=tiles,
        tiles=tiles, quantum=quantum,
        smem_bytes=plan.stages * (n_ranks * plan.span + 20))


# ---------------------------------------------------------------------------
# Philox4x32-10, the stream of K1b/K2b/K3b, in plain PyTorch.
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


@tagging.prng_source
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


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> int32 with the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """Where a block of a larger tensor lies in it, for the Philox stream:
    the block is stored contiguously as ``[n // (n1·n2), n1, n2]`` and its
    element ``(i0, i1, i2)`` is element ``base + i0·s0 + i1·s1 + i2`` of
    the whole tensor (row-major).  :func:`block_geometry` folds any block
    of a placed tensor into this form, or refuses it."""

    n1: int
    n2: int
    s0: int
    s1: int
    base: int

    def global_index(self, e: torch.Tensor) -> torch.Tensor:
        """The whole tensor's flat index of the block's elements ``e``
        (int64)."""
        i2, t = e % self.n2, e // self.n2
        return self.base + (t // self.n1) * self.s0 + (t % self.n1) * self.s1 + i2

    @property
    def aligned(self) -> bool:
        """Four consecutive elements of the block are four consecutive
        elements of the whole from a multiple of four (K1b's 16-byte path
        draws one Philox counter for them)."""
        return all(v % 4 == 0 for v in (self.n2, self.s0, self.s1, self.base))


def block_geometry(shape, origin, block) -> BlockGeometry:
    """The :class:`BlockGeometry` of the block ``block`` (its shape) at
    ``origin`` in a tensor of ``shape``.  Dims the block holds whole fold
    into the dim before them, and a dim the block holds one index of folds
    into the dim after it; a block that leaves more than three dims after
    that has no geometry here and raises."""
    if not (len(shape) == len(origin) == len(block)):
        raise ValueError(f"shape {tuple(shape)}, origin {tuple(origin)} and "
                         f"block {tuple(block)} disagree in rank")
    dims = []                                   # (global, origin, block)
    for g, o, b in zip(shape, origin, block):
        if not (0 <= o and b >= 1 and o + b <= g):
            raise ValueError(f"block {tuple(block)} at {tuple(origin)} is "
                             f"not inside {tuple(shape)}")
        if g == 1:
            continue
        if dims and b == g:                      # whole: folds into the last
            G, O, B = dims[-1]
            dims[-1] = (G * g, O * g, B * g)
        elif dims and dims[-1][2] == 1:          # the last holds one index
            G, O, _ = dims[-1]
            dims[-1] = (G * g, O * g + o, b)
        else:
            dims.append((g, o, b))
    if len(dims) > 3:
        raise ValueError(
            f"block {tuple(block)} at {tuple(origin)} of {tuple(shape)} "
            f"folds to {len(dims)} strided dims; the block Philox stream "
            "takes at most three")
    dims = [(1, 0, 1)] * (3 - len(dims)) + dims
    (_, o0, _), (g1, o1, b1), (g2, o2, b2) = dims
    return BlockGeometry(n1=b1, n2=b2, s0=g1 * g2, s1=g2,
                         base=o0 * g1 * g2 + o1 * g2 + o2)


@tagging.prng_source
def philox_bits(seed: int, n: int, device=None, chunk: int = 1 << 22,
                offset: int = 0, block: Optional[BlockGeometry] = None
                ) -> torch.Tensor:
    """The ``n`` words the in-kernel generator draws for seed ``seed`` from
    element ``offset`` on, as int32 (the uint32 bits reinterpreted): element
    ``e`` takes word ``e % 4`` of counter ``e // 4``.  Computed ``chunk``
    counters at a time to bound the int64 temporaries.  ``block``: the
    ``n`` elements are a block of a larger tensor, element ``e`` taking
    the word of ``block.global_index(e)`` (K1b's block mode)."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned integer, got {seed}")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    if block is not None:
        if offset:
            raise ValueError("a block stream takes no offset")
        out = torch.empty(n, dtype=torch.int32, device=device)
        key = (seed & _LO32, seed >> 32)
        for c in range(0, n, chunk):
            e = torch.arange(c, min(c + chunk, n), dtype=torch.int64,
                             device=device)
            g = block.global_index(e)
            i = g >> 2
            zero = torch.zeros_like(i)
            w = philox4x32_10(torch.stack([i & _LO32, i >> 32, zero, zero],
                                          dim=1), key)
            out[c:c + e.numel()] = _to_int32(
                torch.gather(w, 1, (g & 3)[:, None])[:, 0])
        return out
    c_first, skip = divmod(offset, 4)
    n_ctr = -(-(skip + n) // 4)
    out = torch.empty(n_ctr * 4, dtype=torch.int32, device=device)
    for c in range(0, n_ctr, chunk):
        m = min(chunk, n_ctr - c)
        i = torch.arange(c_first + c, c_first + c + m, dtype=torch.int64,
                         device=device)
        zero = torch.zeros_like(i)
        ctr = torch.stack([i & _LO32, i >> 32, zero, zero], dim=1)
        w = philox4x32_10(ctr, (seed & _LO32, seed >> 32)).reshape(-1)
        # uint32 -> int32 with the same bits
        out[4 * c:4 * (c + m)] = _to_int32(w)
    return out[skip:skip + n]


@dataclasses.dataclass(frozen=True)
class Philox:
    """The in-kernel source of rounding bits of K1b/K2b: the stream
    :func:`philox_bits` gives for the 64-bit ``seed``, element ``e`` of the
    tensor taking the stream's element ``offset + e`` — or, with
    ``block``, the element of the whole tensor the block's element ``e``
    is (K1b's block mode: a rank's block of a placed leaf rounds as the
    whole leaf does there)."""

    seed: int
    offset: int = 0
    block: Optional[BlockGeometry] = None

    def __post_init__(self):
        if not 0 <= self.seed < 1 << 64:
            raise ValueError(f"seed must be a 64-bit unsigned integer, got "
                             f"{self.seed}")
        if self.offset < 0:
            raise ValueError(f"offset must be >= 0, got {self.offset}")
        if self.block is not None and self.offset:
            raise ValueError("a block stream takes no offset")


@dataclasses.dataclass(frozen=True)
class GroupPhilox:
    """K3b's source of rounding bits: one Philox stream per group.

    Group ``g`` draws the stream of ``fold_seed(seed, group_base + g)``, and
    the buffer's element at aligned position ``start + p`` (``p`` from 0)
    takes that stream's element ``start + p - goff[g]``: ``goff`` (int64
    ``[G]``, on the buffer's device) holds the groups' aligned offsets.  So
    the bits of an element depend on its group and its index in the group,
    not on which chunk of the layout a launch covers."""

    seed: int
    goff: torch.Tensor
    start: int = 0
    group_base: int = 0

    def __post_init__(self):
        if not 0 <= self.seed < 1 << 64:
            raise ValueError(f"seed must be a 64-bit unsigned integer, got "
                             f"{self.seed}")
        if self.goff.dtype != torch.int64 or self.goff.ndim != 1:
            raise TypeError("goff must be int64 [G]")


@tagging.prng_source
def group_philox_bits(src: GroupPhilox, tile_group: torch.Tensor,
                      quantum: int) -> torch.Tensor:
    """The words K3b draws for a buffer of ``len(tile_group)`` tiles, in
    plain PyTorch: one :func:`philox_bits` call per run of tiles of one
    group (reads ``tile_group`` and ``goff`` on the host)."""
    tg = tile_group.tolist()
    goff = src.goff.tolist()
    out = torch.empty(len(tg) * quantum, dtype=torch.int32,
                      device=tile_group.device)
    t = 0
    while t < len(tg):
        g, t1 = tg[t], t + 1
        while t1 < len(tg) and tg[t1] == g:
            t1 += 1
        out[t * quantum:t1 * quantum] = philox_bits(
            fold_seed(src.seed, src.group_base + g), (t1 - t) * quantum,
            tile_group.device, offset=src.start + t * quantum - goff[g])
        t = t1
    return out


# ---------------------------------------------------------------------------
# K1 / K1b and K2 / K2b: the quantizer of the training path, and its wire
# flavour.
# ---------------------------------------------------------------------------

def quant_blocks(n: int, groups: int = 1) -> int:
    """The grid-stride body's grid for ``n`` elements when a thread takes
    ``groups`` groups of four elements an iteration (the library's
    ``dps_quant_groups_per_thread``)."""
    return max(1, min(-(-max(n // (4 * groups), 1) // Q_THREADS),
                      Q_MAX_BLOCKS))


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """How K1/K2 are launched: ``body`` "tma" (a ring of ``stages`` stages
    of ``span`` elements filled by bulk copies; ``items`` items of ``rows``
    whole rows each or, with ``rows`` 0, spans of ``span`` inside a row) or
    "stride" (the grid-stride body, its 16-byte path where ``vec``), on
    ``blocks`` blocks of ``threads`` threads asking for ``smem_bytes`` of
    dynamic shared memory.  ``blocks`` is also the partials' row count."""

    body: str
    blocks: int
    threads: int
    span: int = 0
    rows: int = 0
    stages: int = 0
    items: int = 0
    vec: bool = True
    smem_bytes: int = 0


@functools.lru_cache(maxsize=4096)
def quant_plan(n: int, *, x_bytes: int = 4, operand: bool = False,
               wire: bool = False, groups: int = 1,
               geo: Optional["BlockGeometry"] = None,
               vec: bool = True) -> QuantPlan:
    """K1/K2's body, grid and items for ``n`` elements of ``x_bytes`` bytes
    (4 fp32, 2 bf16), rounding from a bits ``operand`` or not, onto the
    ``wire`` or not.  ``groups``: the grid-stride body's groups of four a
    thread (the library's ``dps_quant_groups_per_thread``); ``geo``: K1b's
    block geometry (None: a contiguous tensor, one row of n); ``vec``: x, q
    and the bits lie on 16-byte boundaries (q on its four elements' store)
    and Philox counters fall four elements apart, as the wrapper checks.

    The TMA body takes what it measured faster on (``kernel_ab.py --only
    bodies``), rounded onto q without a bits operand (K1b, or to nearest):
    a block (``geo``), whose counters it steps without the grid-stride
    body's two 64-bit divisions a group, and a contiguous tensor of
    Q_TMA_MIN elements or more; below that size, and K1, K2 and K2b at
    every size, the grid-stride body measured as fast or within 2 %.  Only
    where bulk copies can take it: ``vec``, n > 0 and a row of ``n2``
    elements a 16-byte multiple (a contiguous tensor's row is all of it, so
    an odd tail goes to the grid-stride body).  A stage holds ``span``
    elements, Q_STAGE_BYTES of x.  Rows of ``span``
    elements or more are cut into spans (``rows`` 0, the last of a row
    shorter); shorter rows go whole, ``rows`` of one [n1, n2] slab an item.
    So no item crosses a row it does not hold whole, and a group's Philox
    counter steps by one a group inside a row.  The grid is one block an
    item up to Q_TMA_BLOCKS.  The plan, and with it the statistics'
    summation order, depends on the shape, the dtype and the geometry
    alone (cached: the wrapper asks for it on every launch)."""
    n1, n2 = (geo.n1, geo.n2) if geo is not None else (1, max(n, 1))
    wanted = not (operand or wire) and (geo is not None or n >= Q_TMA_MIN)
    if wanted and vec and n > 0 and (n2 * x_bytes) % 16 == 0:
        span = Q_STAGE_BYTES // x_bytes
        if n2 >= span:
            rows, per, unit = 0, -(-n2 // span), n2
        else:
            rows = min(span // n2, n1)
            per, unit = -(-n1 // rows), n1 * n2
        items = n // unit * per
        return QuantPlan("tma", min(items, Q_TMA_BLOCKS), Q_TMA_THREADS,
                         span, rows, Q_STAGES, items, True,
                         Q_STAGES * (span * x_bytes + Q_STAGE_META))
    return QuantPlan("stride", quant_blocks(n, groups), Q_THREADS, vec=vec)


# the statistics' ticket of each device (see _ticket)
_tickets = {}


@functools.lru_cache(maxsize=2)
def _groups_per_thread(lib, stats: bool) -> int:
    """The library's ``dps_quant_groups_per_thread`` (a constant of the
    build), asked once."""
    return lib.dps_quant_groups_per_thread(int(stats))


def _ticket(device: torch.device) -> torch.Tensor:
    """The int32 ticket K1/K2's last block takes to fold the statistics
    (``finish_stats`` in ``csrc/dps_quant.cu``): one a device, 0 between
    launches (each launch's last block sets it back).  The quantizer
    launches on one stream; two launches at once on two streams would need
    a ticket each.  Made on the first call with statistics, which must not
    be one captured into a CUDA graph (the graph's pool would own it)."""
    t = _tickets.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the quantizer's ticket is made on its first call with "
                "statistics on a device; make that call outside the CUDA "
                "graph capture")
        t = _tickets[device.index] = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
    return t


def _check_quant(x, il, fl, bits, out, out_dtype):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("il", il), ("fl", fl)):
        if t.dtype != torch.int32 or t.numel() != 1:
            raise TypeError(f"{name} must be one int32, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if bits is not None and (bits.dtype not in (torch.int32, torch.uint32)
                             or bits.numel() != x.numel()):
        raise TypeError("bits must be int32/uint32 with x's size")
    if out is not None and (out.dtype != out_dtype or out.shape != x.shape):
        raise TypeError(f"out must be {out_dtype} with x's shape")
    for name, t in (("x", x), ("il", il), ("fl", fl), ("bits", bits),
                    ("out", out)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stats_vector(s):
    return torch.stack([s.count, s.nonzero, s.overflow, s.abs_err_sum,
                        s.rel_err_sum, s.abs_sum, s.max_abs])


def dps_quant_plain(x: torch.Tensor, il: torch.Tensor, fl: torch.Tensor,
                    bits: Optional[torch.Tensor] = None, *,
                    compute_stats: bool = True):
    """K1's function in plain PyTorch: ``fixed_point.quantize`` on x's grid
    ⟨il, fl⟩, stochastic with ``bits`` (32 per element) or to nearest when
    ``bits`` is None.  Returns ``(q, stats float32 [7] | None)``, the stats
    in the order count, nonzero, overflow, abs_err_sum, rel_err_sum,
    abs_sum, max_abs."""
    _check_quant(x, il, fl, bits, None, x.dtype)
    q, s = quantize(
        x, FixedPointFormat(il.reshape(()), fl.reshape(())),
        mode=ROUND_NEAREST if bits is None else ROUND_STOCHASTIC,
        bits=None if bits is None else bits.reshape(x.shape),
        compute_stats=compute_stats)
    return q, (_stats_vector(s) if compute_stats else None)


def dps_quant_wire_plain(x: torch.Tensor, il: torch.Tensor, fl: torch.Tensor,
                         bits: Optional[torch.Tensor] = None, *,
                         compute_stats: bool = True):
    """K2's function in plain PyTorch: ``fixed_point.wire_quantize`` on x's
    grid ⟨il, fl⟩.  Returns ``(wire int8 with x's shape, stats float32 [7]
    | None)``."""
    _check_quant(x, il, fl, bits, None, torch.int8)
    w, s = wire_quantize(
        x, FixedPointFormat(il.reshape(()), fl.reshape(())),
        mode=ROUND_NEAREST if bits is None else ROUND_STOCHASTIC,
        bits=None if bits is None else bits.reshape(x.shape),
        compute_stats=compute_stats)
    return w, (_stats_vector(s) if compute_stats else None)


def _dps_quant_cuda(x, il, fl, bits, philox, compute_stats, out, wire):
    global quantize_launch_count, quantize_prng_launch_count
    global wire_launch_count, wire_prng_launch_count
    global quantize_block_launch_count
    out_dtype = torch.int8 if wire else x.dtype
    _check_quant(x, il, fl, bits, out, out_dtype)
    n = x.numel()
    lib = _build.load()
    q = torch.empty(x.shape, dtype=out_dtype, device=x.device) \
        if out is None else out
    groups = _groups_per_thread(lib, compute_stats)
    src = 0 if bits is None and philox is None else (1 if philox is None else 2)
    # 16-byte loads of x and bits; 16-byte (fp32), 8-byte (bf16) or 4-byte
    # (int8) stores of q; Philox words four to a counter
    geo = philox.block if philox is not None else None
    vec = (all(t.data_ptr() % 16 == 0 for t in (x, bits) if t is not None)
           and q.data_ptr() % (4 if wire else 16) == 0
           and (philox is None or philox.offset % 4 == 0)
           and (geo is None or geo.aligned))
    plan = quant_plan(n, x_bytes=x.element_size(), operand=bits is not None,
                      wire=wire, groups=groups, geo=geo, vec=vec)
    partials = stats = ticket = None
    with torch.cuda.device(x.device):
        if compute_stats:
            partials = torch.empty(plan.blocks * Q_PART, dtype=torch.float64,
                                   device=x.device)
            stats = torch.empty(N_STATS, dtype=torch.float32, device=x.device)
            ticket = _ticket(x.device)
        ptr = lambda t: t.data_ptr() if t is not None else None
        tail = (ptr(partials), ptr(stats), ptr(ticket), plan.blocks,
                int(plan.body == "tma"), int(plan.vec), plan.span, plan.rows,
                plan.stages, torch.cuda.current_stream().cuda_stream)
        if geo is not None:
            entry = "dps_quantize_block"
            args = (x.data_ptr(), int(x.dtype == torch.bfloat16), n,
                    il.data_ptr(), fl.data_ptr(), philox.seed, geo.n1, geo.n2,
                    geo.s0, geo.s1, geo.base, q.data_ptr(), int(wire), *tail)
            code = lib.dps_quantize_block(*args)
            _build.check(lib, code, entry)
            quantize_block_launch_count += not wire
        else:
            entry = "dps_quantize"
            args = (x.data_ptr(), int(x.dtype == torch.bfloat16), n,
                    il.data_ptr(), fl.data_ptr(), ptr(bits), src,
                    philox.seed if philox else 0,
                    philox.offset if philox else 0, q.data_ptr(), int(wire),
                    *tail)
            code = lib.dps_quantize(*args)
            _build.check(lib, code, entry)
    tagging.launch(lambda: quantize_call_geometry(
        n, wire=wire, dtype=str(x.dtype)[6:], block=geo is not None,
        plan=plan), (x, il, fl, bits), (q, stats), args=args,
        philox=src == 2)
    if wire and src == 2:
        wire_prng_launch_count += 1
    elif wire:
        wire_launch_count += 1
    elif src == 2:
        quantize_prng_launch_count += 1
    else:
        quantize_launch_count += 1
    return q, stats


def _quant_call(x, il, fl, bits, compute_stats, out, backend, wire):
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown quantize backend {backend!r}")
    if not (bits is None or isinstance(bits, (torch.Tensor, Philox))):
        raise TypeError("bits must be None (nearest), a tensor of bits or a "
                        f"Philox stream, got {type(bits).__name__}")
    if backend == "plain" or (backend == "auto" and not x.is_cuda):
        if isinstance(bits, Philox):
            bits = philox_bits(bits.seed, x.numel(), x.device,
                               offset=bits.offset, block=bits.block)
        plain = dps_quant_wire_plain if wire else dps_quant_plain
        q, stats = plain(x, il, fl, bits, compute_stats=compute_stats)
        if out is not None:
            out.copy_(q)
            q = out
        return q, stats
    if not x.is_cuda:
        raise ValueError("backend='kernel' needs a CUDA tensor: the "
                         "quantizer is a CUDA kernel")
    if isinstance(bits, Philox):
        return _dps_quant_cuda(x, il, fl, None, bits, compute_stats, out, wire)
    return _dps_quant_cuda(x, il, fl, bits, None, compute_stats, out, wire)


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
    return _quant_call(x, il, fl, bits, compute_stats, out, backend, False)


def dps_quant_wire(x: torch.Tensor, il: torch.Tensor, fl: torch.Tensor,
                   bits: Union[None, torch.Tensor, Philox] = None, *,
                   compute_stats: bool = True,
                   out: Optional[torch.Tensor] = None, backend: str = "auto"):
    """Quantize ``x`` onto ⟨il, fl⟩ and emit the int8 wire payload (K2, or
    K2b with a :class:`Philox` source): the grid integers saturated to
    [-128, 127], the saturated elements counted into ``overflow`` and the
    error measured against the decoded value.  Arguments as in
    :func:`dps_quant`; ``out`` is int8 with x's shape (a slice of a larger
    payload is allowed).  Returns ``(wire, stats float32 [7] | None)``; the
    bytes equal the plain version's."""
    return _quant_call(x, il, fl, bits, compute_stats, out, backend, True)


# ---------------------------------------------------------------------------
# K3 / K3b: the grouped wire encoder.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How K3/K3b are launched: ``blocks`` blocks of ``threads`` threads
    over ``items`` items, block ``b`` taking items ``b, b + blocks, ...``.
    With ``per`` > 1 item ``i`` is piece ``i % per`` of tile ``i // per``
    (``piece`` elements, the last of a tile shorter); with ``per`` 1 it is
    tiles ``[i·run, (i + 1)·run)`` whole (the last item fewer).  ``vec``:
    the 16-byte path (the quantum and the pieces multiples of four, the
    buffers aligned).  ``scratch_bytes``:
    the statistics' scratch (0 without them): a partial row of ``G_PART``
    doubles a slot, ``slots`` slots (one a piece a block may take), then
    int32 run counts a block and two int32 a slot (``GroupScratch`` in
    ``csrc/dps_quant.cu``)."""

    blocks: int
    threads: int
    items: int
    piece: int
    per: int
    run: int
    vec: bool
    slots: int = 0
    scratch_bytes: int = 0


def _group_items(tiles, quantum, size, vec):
    """(per, piece, run, items) with items of about ``size`` elements."""
    if quantum > size:
        per = -(-quantum // size)
        piece = -(-quantum // per)
        if vec:
            piece = -(-piece // 4) * 4
        per = -(-quantum // piece)
        return per, piece, 1, tiles * per
    run = max(1, size // quantum)
    return 1, quantum, run, -(-tiles // run)


@functools.lru_cache(maxsize=4096)
def group_plan(tiles: int, quantum: int, groups: int, x_bytes: int = 4,
               src: int = 0, stats: bool = False,
               aligned: bool = True) -> GroupPlan:
    """K3/K3b's items and grid for ``tiles`` tiles of ``quantum`` elements
    of ``x_bytes`` bytes (4 fp32, 2 bf16) under a ``groups``-row table,
    bits from ``src`` (0 nearest, 1 an operand, 2 Philox), with statistics
    or not, on buffers that lie on 16-byte boundaries (``aligned``) or not.

    A persistent grid: items of about G_ITEM_BYTES of x — pieces of a
    larger tile, runs of whole smaller ones — so no item crosses a tile it
    does not hold whole, and a thread's loads of an item are a few 16-byte
    vectors; fewer bytes an item (down to a quarter, in steps of one
    vector a thread) where there would be fewer than G_MIN_ITEMS_A_BLOCK
    items a block, so that a launch of few tiles (an admission of 128
    pages) spreads evenly over every SM.  Blocks: one an item, at most
    G_BLOCKS.  Every source takes the same items; the statistics add the
    scratch.  The plan, and with it the statistics' summation order,
    depends on the shape, the dtype and the alignment alone (cached: the
    wrapper asks for it on every launch)."""
    if tiles < 0 or quantum < 1 or groups < 0 or src not in (0, 1, 2):
        raise ValueError(f"no plan for {tiles} tiles of {quantum}, "
                         f"{groups} groups, src {src}")
    vec = aligned and quantum % 4 == 0
    size = G_ITEM_BYTES // x_bytes
    per, piece, run, items = _group_items(tiles, quantum, size, vec)
    while (size > G_ITEM_BYTES // x_bytes // 4
           and items < G_MIN_ITEMS_A_BLOCK * G_BLOCKS):
        size -= 4 * Q_THREADS                  # one vector a thread
        per, piece, run, items = _group_items(tiles, quantum, size, vec)
    blocks = max(1, min(G_BLOCKS, items))
    slots = scratch = 0
    if stats:
        slots = items * (1 if per > 1 else run)
        scratch = 8 * G_PART * slots + 4 * (blocks + 2 * slots)
    return GroupPlan(blocks, Q_THREADS, items, piece, per, run, vec, slots,
                     scratch)


def _check(x, fmt_tab, tile_group, bits, mask, quantum, out):
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
    if isinstance(bits, GroupPhilox):
        if bits.goff.numel() != fmt_tab.shape[0]:
            raise ValueError("GroupPhilox.goff needs one offset per table row")
        if bits.goff.device != x.device:
            raise ValueError(f"goff is on {bits.goff.device}, x on {x.device}")
    elif bits is not None and (bits.dtype not in (torch.int32, torch.uint32)
                               or bits.shape != x.shape):
        raise TypeError("bits must be int32/uint32 with x's shape")
    if mask is not None and (mask.dtype != torch.float32
                             or mask.shape != x.shape):
        raise TypeError("mask must be float32 with x's shape")
    if out is not None and (out.dtype != torch.int8 or out.shape != x.shape):
        raise TypeError("out must be int8 with x's shape")
    tensors = (("x", x), ("fmt_tab", fmt_tab), ("tile_group", tile_group),
               ("bits", bits if isinstance(bits, torch.Tensor) else None),
               ("mask", mask), ("out", out))
    for name, t in tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return tiles


def dps_quant_group_wire_plain(x: torch.Tensor, fmt_tab: torch.Tensor,
                               tile_group: torch.Tensor,
                               bits: Union[None, torch.Tensor, GroupPhilox] = None,
                               mask: Optional[torch.Tensor] = None, *,
                               quantum: int, emit_stats: bool = True):
    """The kernel's function in plain PyTorch: ``wire_quantize`` with one
    format per tile (each tile takes its group's table row), then the
    per-tile statistics folded into their group rows as the kernel's last
    block folds its runs: counts as integers, sums in float64, each cast
    to float32 once at the end."""
    tiles = _check(x, fmt_tab, tile_group, bits, mask, quantum, None)
    if isinstance(bits, GroupPhilox):
        bits = group_philox_bits(bits, tile_group, quantum)
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
    groups = fmt_tab.shape[0]
    # per-tile counts are exact in float32 (a tile holds < 2^24 elements)
    counts = torch.zeros(groups, 3, dtype=torch.int64, device=x.device)
    counts.index_add_(0, tg, torch.stack([s.count, s.nonzero, s.overflow],
                                         dim=1).to(torch.int64))
    sums = torch.zeros(groups, 3, dtype=torch.float64, device=x.device)
    sums.index_add_(0, tg, torch.stack([s.abs_err_sum, s.rel_err_sum,
                                        s.abs_sum], dim=1).to(torch.float64))
    mx = torch.zeros(groups, dtype=torch.float32, device=x.device)
    mx.scatter_reduce_(0, tg, s.max_abs, "amax")
    stats = torch.cat([counts.to(torch.float32), sums.to(torch.float32),
                       mx[:, None]], dim=1)
    return wire.reshape(-1), stats


def _dps_quant_group_wire_cuda(x, fmt_tab, tile_group, bits, mask, *,
                               quantum, emit_stats, out):
    global launch_count, group_prng_launch_count
    tiles = _check(x, fmt_tab, tile_group, bits, mask, quantum, out)
    groups = fmt_tab.shape[0]
    lib = _build.load()
    wire = (torch.empty(x.numel(), dtype=torch.int8, device=x.device)
            if out is None else out)
    philox = bits if isinstance(bits, GroupPhilox) else None
    operand = bits if isinstance(bits, torch.Tensor) else None
    src = 2 if philox else (1 if operand is not None else 0)
    ptrs = [t.data_ptr() for t in (x, operand, mask, wire) if t is not None]
    aligned = all(p % 16 == 0 for p in ptrs)
    plan = group_plan(tiles, quantum, groups, x.element_size(), src,
                      emit_stats, aligned)
    scratch = stats = ticket = None
    # the launch is asynchronous; PyTorch's allocator hands freed memory only
    # to later work on the same stream, so the kernel's buffers outlive it
    with torch.cuda.device(x.device):
        if emit_stats:
            scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                                  device=x.device)
            stats = torch.empty(groups, N_STATS, dtype=torch.float32,
                                device=x.device)
            ticket = _ticket(x.device)
        ptr = lambda t: t.data_ptr() if t is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), int(x.dtype == torch.bfloat16),
                fmt_tab.data_ptr(), tile_group.data_ptr(), ptr(operand),
                ptr(mask), src, philox.seed if philox else 0,
                ptr(philox.goff) if philox else None,
                philox.start if philox else 0,
                philox.group_base if philox else 0, wire.data_ptr(),
                ptr(scratch), ptr(stats), ptr(ticket), tiles, quantum,
                groups, plan.blocks, plan.piece, plan.per, plan.run,
                int(plan.vec), stream)
        code = lib.dps_group_wire_encode(*args)
    _build.check(lib, code, "dps_group_wire_encode")
    tagging.launch(lambda: group_wire_call_geometry(
        x.numel(), groups, quantum, tile_group.numel(),
        x_bytes=x.element_size(), src=src, stats=emit_stats,
        aligned=aligned), (x, fmt_tab, tile_group, operand, mask),
        (wire, stats), args=args, philox=src == 2)
    if philox:
        group_prng_launch_count += 1
    else:
        launch_count += 1
    return wire, stats


def dps_quant_group_wire(x: torch.Tensor, fmt_tab: torch.Tensor,
                         tile_group: torch.Tensor,
                         bits: Union[None, torch.Tensor, GroupPhilox] = None,
                         mask: Optional[torch.Tensor] = None, *,
                         quantum: int, emit_stats: bool = True,
                         out: Optional[torch.Tensor] = None,
                         backend: str = "auto"):
    """Per-group ⟨IL, FL⟩ wire encode of a group-aligned flat buffer.

    ``x``: flat fp32/bf16 buffer of ``T · quantum`` elements.  ``fmt_tab``:
    int32 ``[G, 2]`` rows of ``[IL, FL]``.  ``tile_group``: int32 ``[T]``
    mapping tile → table row.  ``bits``: ``None`` rounds to nearest; 32 random
    bits per element (K3) or a :class:`GroupPhilox` stream drawn in the
    kernel (K3b) round stochastically.  ``mask``: float32 1/0 per element,
    zeroing padding out of the wire and the statistics, or ``None``.
    ``out``: int8 ``[T·quantum]`` to write the wire into (a row of a larger
    buffer is allowed).

    Returns ``(wire int8 [T·quantum], stats float32 [G, 7] | None)``.  Wire
    bytes and the integer-valued statistics equal the plain version's bit
    for bit, counts past 2^24 included; the three float sums agree to
    summation order.

    ``backend``: ``"auto"`` launches the CUDA kernel for a CUDA tensor and
    runs the plain version for a CPU tensor; ``"kernel"`` raises for a CPU
    tensor; ``"plain"`` runs the plain version wherever the tensor lies.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown encode backend {backend!r}")
    if backend == "plain" or (backend == "auto" and not x.is_cuda):
        wire, stats = dps_quant_group_wire_plain(
            x, fmt_tab, tile_group, bits, mask, quantum=quantum,
            emit_stats=emit_stats)
        if out is not None:
            out.copy_(wire)
            wire = out
        return wire, stats
    if not x.is_cuda:
        raise ValueError("backend='kernel' needs a CUDA tensor: the grouped "
                         "wire encoder is a CUDA kernel")
    return _dps_quant_group_wire_cuda(x, fmt_tab, tile_group, bits, mask,
                                      quantum=quantum, emit_stats=emit_stats,
                                      out=out)


# ---------------------------------------------------------------------------
# K4: the fused decode-reduce of the receive leg.
# ---------------------------------------------------------------------------

def _check_reduce(wire, fmt_tab, tile_group, quantum):
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    if wire.dtype != torch.int8 or wire.ndim != 2:
        raise TypeError("wire must be int8 [n_ranks, chunk]")
    if wire.shape[0] < 1:
        raise ValueError("wire needs at least one rank row")
    if wire.shape[1] > 1 and wire.stride(1) != 1:
        raise ValueError("each rank row of wire must be contiguous")
    if fmt_tab.dtype != torch.int32 or fmt_tab.ndim != 2 or fmt_tab.shape[1] != 2:
        raise TypeError("fmt_tab must be int32 [G, 2]")
    tiles = -(-wire.shape[1] // quantum)
    if tile_group is not None and (tile_group.dtype != torch.int32
                                   or tuple(tile_group.shape) != (tiles,)):
        raise TypeError(f"tile_group must be int32 [{tiles}]")
    for name, t in (("fmt_tab", fmt_tab), ("tile_group", tile_group)):
        if t is None:
            continue
        if t.device != wire.device:
            raise ValueError(f"{name} is on {t.device}, wire on {wire.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dps_wire_reduce_plain(wire: torch.Tensor, fmt_tab: torch.Tensor,
                          tile_group: Optional[torch.Tensor] = None, *,
                          quantum: int) -> torch.Tensor:
    """K4's function in plain PyTorch: each row decoded with its tiles' FL
    (``wire · 2^-FL``), summed over the rows in row order, divided by the
    row count."""
    _check_reduce(wire, fmt_tab, tile_group, quantum)
    n, chunk = wire.shape
    tiles = -(-chunk // quantum)
    tg = (torch.zeros(tiles, dtype=torch.int64, device=wire.device)
          if tile_group is None else tile_group.to(torch.int64))
    inv = exp2_int(-fmt_tab[tg, 1]).repeat_interleave(quantum)[:chunk]
    acc = torch.zeros(chunk, dtype=torch.float32, device=wire.device)
    for r in range(n):
        acc += wire[r].to(torch.float32) * inv
    # divided by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its float32 reciprocal, which is not the IEEE quotient
    # the kernel and the reference compute (it differs for n = 3)
    return acc / torch.tensor(float(n), device=wire.device)


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """How K4 is launched: ``body`` "tma" (a ring of ``stages`` stages of
    ``span`` elements a row in shared memory, filled by bulk copies) or
    "stride" (the grid-stride body, ``span`` and ``stages`` 0), on
    ``blocks`` blocks."""

    body: str
    blocks: int
    span: int
    stages: int


def reduce_plan(n: int, chunk: int, quantum: int, row_stride: int,
                aligned: bool) -> ReducePlan:
    """K4's body and grid for ``n`` rows of ``chunk`` int8, ``row_stride``
    elements apart, tiles of ``quantum``.  ``aligned``: the wire's base and
    the output lie on 16-byte boundaries.

    The TMA body takes the chunk whenever a bulk copy can: the base, the
    row stride (with more than one row), the chunk and the quantum all
    16-byte multiples, and the stages within a block's shared memory.  A
    stage holds ``RED_STAGE_BYTES`` of rows (``span`` = that over n, a
    multiple of 16, at most the quantum); its items are the spans inside each
    tile, and the grid is one block an item up to ``RED_BLOCKS``.  The
    grid-stride body takes one element a thread, at most ``Q_MAX_BLOCKS``
    blocks.  So the grid depends on the shape alone."""
    span = min(max(16, RED_STAGE_BYTES // n // 16 * 16), quantum)
    if (aligned and chunk % 16 == 0 and quantum % 16 == 0
            and (n == 1 or row_stride % 16 == 0)
            and RED_STAGES * (n * span + 20) <= RED_MAX_SMEM):
        items = -(-chunk // quantum) * -(-quantum // span)
        return ReducePlan("tma", max(1, min(items, RED_BLOCKS)), span,
                          RED_STAGES)
    return ReducePlan("stride", max(1, min(-(-chunk // Q_THREADS),
                                           Q_MAX_BLOCKS)), 0, 0)


def _dps_wire_reduce_cuda(wire, fmt_tab, tile_group, quantum):
    global reduce_launch_count, reduce_tma_launch_count
    _check_reduce(wire, fmt_tab, tile_group, quantum)
    n, chunk = wire.shape
    lib = _build.load()
    out = torch.empty(chunk, dtype=torch.float32, device=wire.device)
    stride = wire.stride(0) if n > 1 else chunk
    plan = reduce_plan(n, chunk, quantum, stride,
                       wire.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)

    with torch.cuda.device(wire.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (wire.data_ptr(), stride, n, chunk, fmt_tab.data_ptr(),
                tile_group.data_ptr() if tile_group is not None else None,
                quantum, out.data_ptr(), plan.blocks, int(plan.body == "tma"),
                plan.span, plan.stages, stream)
        code = lib.dps_wire_reduce(*args)
    _build.check(lib, code, "dps_wire_reduce")
    grouped = tile_group is not None       # else one format, no tile map
    tagging.launch(lambda: wire_reduce_call_geometry(
        n, chunk, fmt_tab.shape[0], quantum if grouped else None, plan),
        (wire, fmt_tab, tile_group), (out,), args=args)
    reduce_launch_count += 1
    if plan.body == "tma":
        reduce_tma_launch_count += 1
    return out


def dps_wire_reduce(wire: torch.Tensor, fmt_tab: torch.Tensor,
                    tile_group: Optional[torch.Tensor] = None, *,
                    quantum: int, backend: str = "auto") -> torch.Tensor:
    """Fused int8 decode → mean over the rank rows (the receive leg).

    ``wire``: int8 ``[n_ranks, chunk]``, each row contiguous, the rows any
    distance apart (a strided view into a stacked payload is taken as it
    is).  ``fmt_tab``: int32 ``[G, 2]``; ``tile_group``: int32
    ``[ceil(chunk / quantum)]`` mapping this chunk's tiles to table rows, or
    ``None`` when every tile takes row 0 (a global format).  The last tile
    may be ragged.  Returns the fp32 ``[chunk]`` mean, bit-equal to the plain
    version (every addend is an exact multiple of its 2^-FL).

    ``backend``: as for :func:`dps_quant_group_wire`.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown reduce backend {backend!r}")
    if backend == "plain" or (backend == "auto" and not wire.is_cuda):
        return dps_wire_reduce_plain(wire, fmt_tab, tile_group, quantum=quantum)
    if not wire.is_cuda:
        raise ValueError("backend='kernel' needs a CUDA tensor: the wire "
                         "reduce is a CUDA kernel")
    return _dps_wire_reduce_cuda(wire, fmt_tab, tile_group, quantum)
