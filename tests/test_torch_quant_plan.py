"""K1/K1b/K2/K2b's launch plan, on the CPU.

``kernels/dps_quant.py::quant_plan`` chooses the quantizer's body (the TMA
body or the grid-stride body), its grid, its stages and its items;
``_item_head`` below works an item out as the kernel's ``item_head``
(``csrc/dps_quant.cu``) does.  These tests hold, for the placed step's
blocks and the edge shapes ``chip_smoke.py`` runs on the card:

* the items tile the tensor exactly once, in storage order;
* no item crosses a row it does not hold whole (spans inside a row, or
  whole rows of one slab);
* each item's first Philox counter is ``BlockGeometry.global_index`` of its
  first element over four, and the counters a consumer thread steps to
  (one carry a group, no division) are those of its groups' first
  elements: consecutive within a row;
* what a bulk copy cannot take (a pointer or a Philox offset off 16 bytes,
  an odd tail, a bf16 row off 16 bytes) goes to the grid-stride body, as do
  the launches measured faster there;
* the grid, threads and dynamic shared memory are ``quantize_call_geometry``'s,
  so the recorded launches hold to the same plan.
"""

import pytest
import torch

from repro_torch.analysis import kernel_checks
from repro_torch.kernels import dps_quant as dq

# (whole shape, block origin, block shape, element bytes): one rank's block of
# one layer of llama3.2-3b's w_in at (1, 4) and (2, 4), the whole 28-layer
# leaf's block at (1, 4), and the TMA body's edges that chip_smoke.py runs
BLOCKS = {
    "w_in_layer_1x4": ((3072, 8192), (0, 2048), (3072, 2048), 4),
    "w_in_layer_2x4": ((3072, 8192), (1536, 2048), (1536, 2048), 4),
    "w_in_leaf_1x4": ((28, 3072, 8192), (0, 0, 2048), (28, 3072, 2048), 4),
    "spans_in_rows": ((64, 16384), (0, 4096), (64, 8192), 4),
    "ragged_rows": ((48, 12000), (0, 6000), (48, 6000), 4),
    "short_rows_wrap": ((256, 1024), (64, 256), (128, 512), 4),
    "ragged_slab": ((4, 500, 80), (1, 50, 40), (2, 250, 40), 4),
    "bf16_rows": ((64, 8192), (0, 2048), (64, 2048), 2),
    "one_row_short": ((8, 96), (3, 0), (1, 96), 4),
}
# contiguous launches on the TMA body: (elements, element bytes, offset)
CONTIGUOUS = {"fp32_short_last_item": (dq.Q_TMA_MIN + 8, 4, 0),
              "bf16_short_last_item": (dq.Q_TMA_MIN + 8, 2, 0),
              "fp32_offset": (dq.Q_TMA_MIN, 4, 4),
              "w_in_leaf": (28 * 3072 * 8192, 4, 0)}
# groups a consumer thread takes at once, as the kernel's Q_CONSUMERS
CONSUMERS = dq.Q_TMA_THREADS - 32


def _block(name):
    whole, origin, shape, xb = BLOCKS[name]
    geo = dq.block_geometry(whole, origin, shape)
    n = 1
    for b in shape:
        n *= b
    return n, xb, geo


def _contiguous(name):
    n, xb, off = CONTIGUOUS[name]
    return n, xb, dq.BlockGeometry(n1=1, n2=n, s0=0, s1=0, base=off)


def _case(kind, name):
    if kind == "block":
        n, xb, geo = _block(name)
        return n, xb, geo, dq.quant_plan(n, x_bytes=xb, geo=geo)
    n, xb, geo = _contiguous(name)
    return n, xb, geo, dq.quant_plan(n, x_bytes=xb)


CASES = ([("block", k) for k in BLOCKS]
         + [("contiguous", k) for k in CONTIGUOUS])


def _item_head(plan, i, geo):
    """Item ``i`` of a TMA plan as the kernel's producer works it out:
    ``(start, length, counter)``, its first element, its elements, and the
    Philox counter of its first group of four (a contiguous tensor is the
    geometry [1, 1, n] at base ``ctr_base``)."""
    per = (-(-geo.n2 // plan.span) if plan.rows == 0
           else -(-geo.n1 // plan.rows))
    if plan.rows == 0:
        row, k = divmod(i, per)
        i0, i1 = divmod(row, geo.n1)
        off = k * plan.span
        start, length = row * geo.n2 + off, min(plan.span, geo.n2 - off)
    else:
        i0, k = divmod(i, per)
        i1, off = k * plan.rows, 0
        start = (i0 * geo.n1 + i1) * geo.n2
        length = min(plan.rows, geo.n1 - i1) * geo.n2
    return start, length, (geo.base + i0 * geo.s0 + i1 * geo.s1 + off) >> 2


def _items(plan, geo):
    return [_item_head(plan, i, geo) for i in range(plan.items)]


@pytest.mark.parametrize("kind,name", CASES)
def test_items_tile_the_tensor_exactly_once(kind, name):
    n, xb, geo, plan = _case(kind, name)
    assert plan.body == "tma"
    items = _items(plan, geo)
    pos = 0
    for start, length, _ in items:
        assert start == pos, "items out of storage order or overlapping"
        assert 0 < length <= plan.span
        assert length % 4 == 0
        assert (start * xb) % 16 == 0 and (length * xb) % 16 == 0
        pos += length
    assert pos == n


@pytest.mark.parametrize("kind,name", CASES)
def test_no_item_crosses_a_row_it_does_not_hold_whole(kind, name):
    n, _, geo, plan = _case(kind, name)
    n2, slab = geo.n2, geo.n1 * geo.n2
    for start, length, _ in _items(plan, geo):
        last = start + length - 1
        if plan.rows == 0:
            # a span inside one row
            assert geo.n2 >= plan.span or length == geo.n2
            assert start // n2 == last // n2
        else:
            # whole rows of one slab, at most `rows` of them
            assert geo.n2 < plan.span
            assert start % n2 == 0 and length % n2 == 0
            assert length // n2 <= plan.rows <= plan.span // n2
            assert start // slab == last // slab


def _thread_counters(plan, geo, ctr, groups):
    """The counters the kernel's consumer threads step to over an item's
    ``groups`` groups (``consume_items``): thread t starts at (row, word)
    = divmod(t, W) and steps by divmod(Q_CONSUMERS, W) with one carry.
    Returns the counter of each group, indexed by group."""
    W = geo.n2 // 4 if plan.rows else plan.span // 4
    s1 = geo.s1 // 4
    dq_, dr = divmod(CONSUMERS, W)
    out = torch.empty(groups, dtype=torch.int64)
    for t in range(min(CONSUMERS, groups)):
        r0, w0 = divmod(t, W)
        rowc, w = ctr + r0 * s1, w0
        for j in range(t, groups, CONSUMERS):
            out[j] = rowc + w
            w += dr
            rowc += dq_ * s1
            if w >= W:
                w -= W
                rowc += s1
    return out


@pytest.mark.parametrize("kind,name", CASES)
def test_counters_are_the_global_index_and_step_by_one_in_a_row(kind, name):
    n, _, geo, plan = _case(kind, name)
    items = _items(plan, geo)
    # every item of the small cases; the first, last and a middle one else
    pick = (range(len(items)) if len(items) <= 64
            else (0, 1, len(items) // 2, len(items) - 1))
    for i in pick:
        start, length, ctr = items[i]
        first = geo.global_index(torch.tensor([start]))
        assert ctr == int(first) // 4
        groups = length // 4
        e = start + 4 * torch.arange(groups, dtype=torch.int64)
        want = geo.global_index(e)
        assert bool((want % 4 == 0).all())
        got = _thread_counters(plan, geo, ctr, groups)
        assert torch.equal(got, want // 4)
        # consecutive inside a row
        row = e // geo.n2
        same = row[1:] == row[:-1]
        assert bool(((got[1:] - got[:-1])[same] == 1).all())


def test_the_philox_stream_of_the_items_is_the_block_stream():
    """The words the items' counters give, element by element, are
    ``philox_bits(..., block=geo)``'s (the kernel's q is held to them on the
    card; here the arithmetic that feeds them)."""
    n, _, geo = _block("ragged_slab")
    plan = dq.quant_plan(n, geo=geo)
    want = dq.philox_bits(9, n, block=geo)
    got = torch.empty(n, dtype=torch.int32)
    for i in range(plan.items):
        start, length, ctr = _item_head(plan, i, geo)
        groups = length // 4
        c = _thread_counters(plan, geo, ctr, groups)
        words = dq.philox4x32_10(
            torch.stack([c & 0xFFFFFFFF, c >> 32, torch.zeros_like(c),
                         torch.zeros_like(c)], dim=1), (9, 0))
        got[start:start + length] = dq._to_int32(words.reshape(-1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("args,body", [
    (dict(n=dq.Q_TMA_MIN), "tma"),                       # K1b, to nearest
    (dict(n=dq.Q_TMA_MIN - 4), "stride"),                # measured faster
    (dict(n=dq.Q_TMA_MIN, operand=True), "stride"),      # K1
    (dict(n=dq.Q_TMA_MIN, wire=True), "stride"),         # K2b
    (dict(n=dq.Q_TMA_MIN, vec=False), "stride"),         # a pointer off 16 B
    (dict(n=dq.Q_TMA_MIN + 2), "stride"),                # an odd tail
    (dict(n=dq.Q_TMA_MIN + 4, x_bytes=2), "stride"),     # a bf16 row off 16 B
    (dict(n=dq.Q_TMA_MIN + 8, x_bytes=2), "tma"),
    (dict(n=0), "stride"),
])
def test_what_a_bulk_copy_cannot_take_goes_to_the_grid_stride_body(args,
                                                                   body):
    plan = dq.quant_plan(**args)
    assert plan.body == body
    if body == "stride":
        assert (plan.threads, plan.span, plan.stages, plan.smem_bytes) == (
            dq.Q_THREADS, 0, 0, 0)
        assert plan.blocks == dq.quant_blocks(args["n"], 1)
        assert plan.vec == args.get("vec", True)


@pytest.mark.parametrize("whole,origin,shape,xb,body", [
    ((3072, 8192), (0, 2048), (3072, 2048), 4, "tma"),
    ((3072, 8192), (0, 2048), (3072, 2048), 2, "tma"),
    ((40, 90), (0, 30), (40, 30), 4, "stride"),          # a row of 120 B
    ((40, 100), (0, 52), (40, 36), 2, "stride"),         # a bf16 row of 72 B
])
def test_a_block_takes_the_tma_body_where_its_rows_allow(whole, origin, shape,
                                                         xb, body):
    geo = dq.block_geometry(whole, origin, shape)
    n = shape[0] * shape[1]
    assert dq.quant_plan(n, x_bytes=xb, geo=geo).body == body
    # the wrapper's alignment test: an unaligned geometry never asks for it
    assert dq.quant_plan(n, x_bytes=xb, geo=geo, vec=False).body == "stride"


@pytest.mark.parametrize("kind,name", CASES)
def test_grid_and_shared_memory_are_the_call_geometrys(kind, name):
    n, xb, geo, plan = _case(kind, name)
    g = dq.quantize_call_geometry(n, dtype="bfloat16" if xb == 2 else
                                  "float32", block=kind == "block",
                                  plan=plan)
    assert g.grid == (plan.blocks,) and g.threads == plan.threads
    assert g.smem_bytes == plan.smem_bytes
    assert plan.blocks == min(plan.items, dq.Q_TMA_BLOCKS)
    assert plan.smem_bytes == plan.stages * (
        plan.span * xb + dq.Q_STAGE_META)
    assert plan.smem_bytes <= dq.Q_MAX_DYN_SMEM
    assert (plan.span * xb) % 16 == 0 and plan.span % 8 == 0
    assert kernel_checks.check_call(g).ok
    # the plan is a function of the shape, dtype and geometry alone
    again = dq.quant_plan(n, x_bytes=xb,
                          geo=geo if kind == "block" else None)
    assert again == plan


@pytest.mark.parametrize("n,dtype,wire", [
    (1 << 16, "float32", False), (dq.Q_TMA_MIN, "float32", False),
    (dq.Q_TMA_MIN, "bfloat16", False), (dq.Q_TMA_MIN, "float32", True),
    (100, "float32", True)])
def test_the_default_call_geometry_is_the_default_plan(n, dtype, wire):
    g = dq.quantize_call_geometry(n, dtype=dtype, wire=wire)
    plan = dq.quant_plan(n, x_bytes=2 if dtype == "bfloat16" else 4,
                         wire=wire)
    assert (g.grid, g.threads, g.smem_bytes) == (
        (plan.blocks,), plan.threads, plan.smem_bytes)
    assert g.out_dtype == ("int8" if wire else dtype)
    assert kernel_checks.check_call(g).ok


@pytest.mark.parametrize("operand,wire", [(True, False), (False, True),
                                          (True, True)])
def test_a_bits_operand_or_the_wire_stays_on_the_grid_stride_body(operand,
                                                                  wire):
    """The TMA body writes q in x's type from Philox bits or to nearest;
    K1, K2 and K2b measured as fast or within 2 % on the grid-stride body,
    so neither a block nor a large tensor takes it there."""
    n, xb, geo = _block("w_in_layer_1x4")
    for args in (dict(n=n, geo=geo), dict(n=dq.Q_TMA_MIN)):
        plan = dq.quant_plan(**args, x_bytes=xb, operand=operand, wire=wire)
        assert plan.body == "stride"
        assert plan.blocks == dq.quant_blocks(args["n"], 1)


def test_the_cpu_wrapper_runs_the_plain_version():
    x = torch.randn(64, 256)
    geo = dq.block_geometry((64, 1024), (0, 256), (64, 256))
    before = (dq.quantize_launch_count, dq.quantize_prng_launch_count,
              dq.quantize_block_launch_count)
    il, fl = torch.tensor([2], dtype=torch.int32), torch.tensor(
        [14], dtype=torch.int32)
    q, s = dq.dps_quant(x, il, fl, dq.Philox(5, block=geo))
    qp, sp = dq.dps_quant_plain(x, il, fl, dq.philox_bits(
        5, x.numel(), block=geo))
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert (dq.quantize_launch_count, dq.quantize_prng_launch_count,
            dq.quantize_block_launch_count) == before
