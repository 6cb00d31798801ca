"""K4's arithmetic and launch plan, on the CPU.

K4's TMA body (``csrc/dps_quant.cu``, ``wire_reduce_tma_kernel``) sums the n
int8 of an element as integers: each row's four bytes of a 4-byte word,
biased by 128 to [0, 255], are added as two pairs of 16-bit lanes, at most
256 rows a pass.  It then takes ``float(sum) * 2^-FL`` and divides by n (a
product with 1/n when n is a power of two).  :func:`kernel_mean` does
exactly that in numpy.  These tests hold it, bit for bit, against

* ``dps_wire_reduce_plain``, the float decode-then-sum that the kernel is
  held against on the card: n ∈ {1, 2, 3, 4, 7, 8, 16, 300}, FL from -24 to
  130, per-tile tables with G > 1 and a global format, strided rows, ragged
  chunks, rows at the int8 extremes;
* the reference's ``dps_wire_reduce_pallas`` in interpret mode, on chunks
  that are multiples of its 4096-element quantum.  Its integer sums are the
  same; its last step is not an IEEE division when n is not a power of two:
  XLA's CPU backend turns ``sum / n`` by the constant n into a product with
  the float32 1/n, one ulp off the quotient on some elements.  So the model
  is held to the reference with that product in place of the division, and
  to the plain version (and the kernel) with the division.

And the wrapper's :func:`~repro_torch.kernels.dps_quant.reduce_plan`: the
TMA body exactly when bulk copies can take the rows, and a grid that depends
on the shape alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import dps_quant
from test_torch_jaxref import run_reference

# FL of the table rows: the wire's range and past it on both sides (2^-FL
# stops at 2^-126 in both versions)
FLS = (-24, -7, -1, 0, 3, 7, 15, 40, 126, 130)
NS = (1, 2, 3, 4, 7, 8, 16, 300)
# name -> (chunk, quantum, row padding, global format)
SHAPES = {"one_tile": (4096, 4096, 0, False),
          "ragged_strided": (12345, 4096, 7, False),
          "small_quantum_strided": (1000, 96, 32, False),
          "odd_quantum_global": (777, 7, 5, True)}


def _exp2i(n):
    n = np.clip(np.asarray(n, np.int64), -126, 127)
    return ((n + 127) << 23).astype(np.int32).view(np.float32)


def kernel_mean(wire, fl_tab, tile_group, quantum, reciprocal=False):
    """The TMA body's arithmetic on int8 ``wire [n, chunk]``: ``fl_tab``
    the table's FL column, ``tile_group`` the tiles' rows (None: row 0).
    ``reciprocal``: the last step is the product with the float32 1/n for
    every n, as the reference's kernel computes it on the CPU."""
    n, chunk = wire.shape
    words = np.ascontiguousarray(
        np.pad(wire, ((0, 0), (0, -chunk % 4)))).view("<u4")
    sums = np.zeros((words.shape[1], 4), np.int64)
    for r0 in range(0, n, 256):
        x = words[r0:r0 + 256] ^ np.uint32(0x80808080)
        lo = (x & np.uint32(0x00FF00FF)).sum(0, dtype=np.uint32)
        hi = ((x >> np.uint32(8)) & np.uint32(0x00FF00FF)).sum(0, dtype=np.uint32)
        bias = 128 * x.shape[0]
        for b, lanes in enumerate((lo & 0xFFFF, hi & 0xFFFF, lo >> 16,
                                   hi >> 16)):
            sums[:, b] += lanes.astype(np.int64) - bias
    s = sums.reshape(-1)[:chunk]
    assert np.abs(s).max(initial=0) < 1 << 24        # exact in float32
    tiles = np.arange(chunk) // quantum
    g = np.zeros_like(tiles) if tile_group is None else tile_group[tiles]
    v = s.astype(np.float32) * _exp2i(-fl_tab[g])    # exact: a power of two
    if reciprocal or n & (n - 1) == 0:
        return v * (np.float32(1) / np.float32(n))   # v / n when n = 2^k
    return v / np.float32(n)


def _case(rng, n, chunk, quantum, pad, global_fmt):
    """Rows ``pad`` elements apart (a strided view), the first columns at the
    int8 extremes; a table of every FL in FLS."""
    big = rng.integers(-128, 127, (n, chunk + pad), dtype=np.int8,
                       endpoint=True)
    big[:, :3] = 127
    big[:, 3:6] = -128
    tab = np.stack([8 - np.asarray(FLS), FLS], 1).astype(np.int32)
    tiles = -(-chunk // quantum)
    if global_fmt:
        tab, tg = tab[:1], None
    else:
        tg = rng.integers(0, len(FLS), tiles).astype(np.int32)
    return big, tab, tg


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("n", NS)
def test_integer_accumulation_is_the_plain_mean_bit_for_bit(n, name):
    chunk, quantum, pad, global_fmt = SHAPES[name]
    rng = np.random.default_rng(n * 1000 + len(name))
    big, tab, tg = _case(rng, n, chunk, quantum, pad, global_fmt)
    wire = torch.from_numpy(big)[:, :chunk]
    assert wire.stride(0) == chunk + pad
    want = dps_quant.dps_wire_reduce_plain(
        wire, torch.from_numpy(tab),
        None if tg is None else torch.from_numpy(tg), quantum=quantum)
    got = kernel_mean(big[:, :chunk], tab[:, 1], tg, quantum)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))


# name -> (n, chunk, G): chunks that are multiples of the reference's quantum
PALLAS = {"one_rank": (1, 4096, 1), "three_ranks": (3, 12288, 3),
          "four_ranks": (4, 8192, 2), "seven_ranks": (7, 8192, 4)}
PALLAS_Q = 4096


def _pallas_inputs():
    rng = np.random.default_rng(16)
    arrays = {}
    for name, (n, chunk, G) in PALLAS.items():
        wire = rng.integers(-128, 127, (n, chunk), dtype=np.int8,
                            endpoint=True)
        fl = rng.choice(np.asarray(FLS[:8]), G).astype(np.int32)
        arrays[f"k4/{name}/wire"] = wire
        arrays[f"k4/{name}/fmt_tab"] = np.stack([8 - fl, fl], 1).astype(np.int32)
        arrays[f"k4/{name}/tile_group"] = rng.integers(
            0, G, chunk // PALLAS_Q).astype(np.int32)
    return arrays


@pytest.fixture(scope="module")
def pallas():
    arrays = _pallas_inputs()
    out = run_reference([{"job": "wire_reduce_pallas", "tag": "k4",
                          "kw": {"names": sorted(PALLAS),
                                 "quantum": PALLAS_Q}}], arrays)
    return arrays, out


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_integer_accumulation_is_the_reference_kernel_bit_for_bit(pallas, name):
    arrays, out = pallas
    p = f"k4/{name}/"
    wire, tab, tg = (arrays[p + k] for k in ("wire", "fmt_tab", "tile_group"))
    want = out[p + "mean"]
    got = kernel_mean(wire, tab[:, 1], tg, PALLAS_Q, reciprocal=True)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = dps_quant.dps_wire_reduce_plain(
        torch.from_numpy(wire), torch.from_numpy(tab), torch.from_numpy(tg),
        quantum=PALLAS_Q)
    mean = kernel_mean(wire, tab[:, 1], tg, PALLAS_Q)
    np.testing.assert_array_equal(mean.view(np.int32),
                                  plain.numpy().view(np.int32))
    n = wire.shape[0]
    if n & (n - 1) == 0:
        np.testing.assert_array_equal(mean.view(np.int32), want.view(np.int32))
    else:        # the quotient and the reciprocal's product: one ulp apart
        ulps = np.abs(mean.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() == 1


# (n, chunk, quantum, row_stride, aligned) -> the body; one rule broken at a
# time, and the full-width shapes of the wire and overlap runs
PLANS = [
    ((4, 803_385_344, 4096, 4 * 803_385_344, True), "tma"),
    ((4, 176_160_768, 4096, 4 * 176_160_768, True), "tma"),
    ((4, 176_160_768, 4096, 176_160_768, True), "tma"),
    ((4, 4096, 4096, 16384, True), "tma"),
    ((1, 4096, 4096, 4101, True), "tma"),        # one row: no stride used
    ((16, 4096 * 3, 4096, 4096 * 3, True), "tma"),
    ((300, 4096, 4096, 4096, True), "tma"),
    ((4, 9216, 4096, 9216, True), "tma"),        # ragged last tile
    ((4, 16384, 1024, 16384, True), "tma"),      # quantum below the span
    ((4, 20480, 16384, 20512, True), "tma"),     # quantum above the span
    ((4, 8192, 4096, 8208, False), "stride"),    # aligned stride, base not
    ((4, 8192, 4096, 8200, True), "stride"),     # stride off 16
    ((4, 8200, 4096, 8200, True), "stride"),     # chunk off 16
    ((4, 8192, 4104, 8192, True), "stride"),     # quantum off 16
    ((4, 777, 7, 782, True), "stride"),
    ((4000, 4096, 4096, 4096, True), "stride"),  # the stages do not fit
]


@pytest.mark.parametrize("args,body", PLANS)
def test_reduce_plan_takes_the_tma_body_where_bulk_copies_can(args, body):
    n, chunk, quantum, row_stride, aligned = args
    plan = dps_quant.reduce_plan(*args)
    assert plan.body == body
    assert plan == dps_quant.reduce_plan(*args)
    if body == "stride":
        assert (plan.span, plan.stages) == (0, 0)
        assert plan.blocks == max(1, min(-(-chunk // dps_quant.Q_THREADS),
                                         dps_quant.Q_MAX_BLOCKS))
        return
    # whole 16-byte copies inside one tile, the ring within 227 KB
    assert plan.span % 16 == 0 and 16 <= plan.span <= quantum
    assert n * plan.span <= max(dps_quant.RED_STAGE_BYTES, 16 * n)
    assert plan.stages * (n * plan.span + 20) <= dps_quant.RED_MAX_SMEM
    items = -(-chunk // quantum) * -(-quantum // plan.span)
    assert plan.blocks == min(items, dps_quant.RED_BLOCKS)


def test_reduce_plan_grid_depends_on_the_shape_alone():
    """The stride of the rows and their alignment choose the body, never
    the grid of a body; a small chunk gets one block a tile."""
    a = dps_quant.reduce_plan(4, 8192, 4096, 8192, True)
    b = dps_quant.reduce_plan(4, 8192, 4096, 4 * 8192 + 4096 * 16, True)
    assert a == b and a.blocks == 2
    c = dps_quant.reduce_plan(4, 8192, 4096, 8193, True)
    d = dps_quant.reduce_plan(4, 8192, 4096, 8192, False)
    assert c == d and c.body == "stride"
    wire = torch.zeros(4, 8192, dtype=torch.int8)
    tab = torch.tensor([[2, 6]], dtype=torch.int32)
    dps_quant.dps_wire_reduce(wire, tab, quantum=4096)          # the CPU: plain
    assert dps_quant.reduce_launch_count == 0
    assert dps_quant.reduce_tma_launch_count == 0
