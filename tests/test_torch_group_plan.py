"""K3/K3b's launch plan (``kernels/dps_quant.py::group_plan``) on the CPU.

The grouped wire encoder is a persistent grid over items — pieces of a
larger tile, or runs of whole smaller ones — block b taking items b, b +
grid, ...  These tests hold the plan to what the
kernel relies on — every element of every tile taken exactly once, no item
across a tile boundary, each item's Philox counter the element's index in
its group's stream — at every config's admission shape and at the wire's
chunks, and the launch geometry the verifier checks to the plan.  They also
hold the page encoder's dropped mask: on a buffer zeroed at its padding
(``-0.0`` included) the plain encoder gives the same bytes without it.
Pure PyTorch and numpy: no reference child, no card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernel_checks
from repro_torch.core.fixed_point import FixedPointFormat, fold_seed
from repro_torch.dist import group_layout
from repro_torch.kernels import dps_quant as dq
from repro_torch.kernels import ops
from repro_torch.serve import cache as kvc

# (tiles, quantum) of each config's admission: 2 * layers * 32 prompt pages
# of 16 * KV * Dh, at the depths chip_smoke.py serves them
ADMISSIONS = {"llama3_2_3b": (1792, 16384), "gemma_7b": (1792, 65536),
              "mistral_large_123b": (512, 16384),
              "nemotron_4_340b": (128, 24576),
              "qwen3_moe_30b_a3b": (2048, 8192)}
# owner chunks of the wire at quantum 4096: llama3.2-3b's and mamba2-1.3b's
# per-leaf layouts over 4 ranks, the overlap run's w_in bucket
WIRE_CHUNKS = {"llama_owner": 803_385_344, "w_in_bucket": 176_160_768,
               "mamba2_owner": 336_146_432}
# small shapes: one tile, fewer tiles than SMs, tiles cut into pieces, odd
# quanta (the element path), bf16 spans
SMALL = [(1, 16, 4), (1, 100_003, 4), (7, 4096, 4), (100, 4096, 4),
         (3, 65536, 4), (9, 7, 4), (11, 1, 4), (131, 24576, 2),
         (5, 1024, 2), (0, 4096, 4)]


def _pieces(plan, tiles, quantum):
    """The pieces of ``plan`` in the order the blocks take them, as the
    kernel walks them: ``(block, item, tile, offset in the tile,
    length)``."""
    for b in range(plan.blocks):
        for i in range(b, plan.items, plan.blocks):
            if plan.per > 1:
                t, k = divmod(i, plan.per)
                off = k * plan.piece
                yield b, i, t, off, min(plan.piece, quantum - off)
            else:
                for t in range(i * plan.run, min(tiles, (i + 1) * plan.run)):
                    yield b, i, t, 0, quantum


def _items(plan, tiles, quantum):
    return list(_pieces(plan, tiles, quantum))


def _hold_cover(plan, tiles, quantum):
    """Every element of every tile once; no item across a tile it does not
    hold whole; block b takes items b, b + blocks, ...; every block at
    least one item; the grid within the card's."""
    n = tiles * quantum
    pieces = _items(plan, tiles, quantum)
    assert 1 <= plan.blocks <= dq.G_BLOCKS
    assert plan.threads == dq.Q_THREADS
    by_item = {}
    for b, i, t, off, ln in pieces:
        assert 0 <= t < tiles and 0 <= off and ln >= 1
        assert off + ln <= quantum                   # inside its tile
        assert i % plan.blocks == b
        by_item.setdefault(i, []).append((t, off, ln))
    assert sorted(by_item) == list(range(plan.items))
    for runs in by_item.values():                    # an item: one piece of
        assert len(runs) == 1 or all(o == 0 and ln == quantum   # a tile, or
                                     for _, o, ln in runs)      # whole tiles
    e = 0
    for t, off, ln in sorted((t, o, ln) for _, _, t, o, ln in pieces):
        assert t * quantum + off == e                # no gap, no overlap
        e += ln
    assert e == n
    if n:
        assert plan.blocks == min(plan.items, plan.blocks)
        assert {b for b, *_ in pieces} == set(range(plan.blocks))
    else:
        assert plan.blocks == 1 and pieces == []
    if plan.vec:
        assert all(off % 4 == 0 and ln % 4 == 0 for *_, off, ln in pieces)
    return pieces


@pytest.mark.parametrize("tiles,quantum,x_bytes", SMALL)
@pytest.mark.parametrize("stats", [False, True])
def test_small_plans_cover_every_element_once(tiles, quantum, x_bytes,
                                              stats):
    plan = dq.group_plan(tiles, quantum, 3, x_bytes, 0, stats, True)
    _hold_cover(plan, tiles, quantum)
    assert plan.vec == (quantum % 4 == 0)
    off = dq.group_plan(tiles, quantum, 3, x_bytes, 0, stats, False)
    assert not off.vec
    _hold_cover(off, tiles, quantum)


@pytest.mark.parametrize("model", sorted(ADMISSIONS))
def test_admission_plans(model):
    """At every admission the grid fills the card and the blocks' shares
    differ by one item at most: nemotron's 128 pages become pieces, at
    least 2 x 132 items, every tile cut."""
    T, q = ADMISSIONS[model]
    plan = dq.group_plan(T, q, T, 4, 0, False, True)
    pieces = _hold_cover(plan, T, q)
    assert plan.blocks == dq.G_BLOCKS
    assert plan.items >= 2 * 132
    share = [0] * plan.blocks
    for b, *_ in pieces:
        share[b] += 1
    assert max(share) - min(share) <= 1
    assert plan.piece <= dq.G_ITEM_BYTES // 4
    if model == "nemotron_4_340b":
        assert plan.per > 1
        assert plan.items >= dq.G_MIN_ITEMS_A_BLOCK * plan.blocks


@pytest.mark.parametrize("tag", sorted(WIRE_CHUNKS))
def test_wire_chunk_plans(tag):
    """At a wire chunk an item is one whole tile of 4,096, and the grid is
    the card's."""
    c = WIRE_CHUNKS[tag]
    T = c // 4096
    plan = dq.group_plan(T, 4096, 11, 4, 2, True, True)
    _hold_cover(plan, T, 4096)
    assert plan.blocks == dq.G_BLOCKS
    assert (plan.per, plan.run, plan.items) == (1, 1, T)
    assert plan.slots == T
    assert plan.scratch_bytes == (8 * dq.G_PART * T
                                  + 4 * (plan.blocks + 2 * T))
    assert dq.group_plan(T, 4096, 11, 4, 2, False, True).scratch_bytes == 0


def test_run_slots_of_the_blocks_do_not_meet():
    """The statistics' slots: block b's runs take its slots from the items
    before its own on, one a piece it takes at most; no two blocks share a
    slot and every slot lies inside the scratch."""
    for tiles, quantum in ((128, 24576), (1792, 16384), (9, 7), (1, 16),
                           (7, 4096), (300, 100), (5, 100_003)):
        plan = dq.group_plan(tiles, quantum, tiles, 4, 0, True, True)
        mult = 1 if plan.per > 1 else plan.run
        taken = {}
        for b, *_ in _pieces(plan, tiles, quantum):
            taken[b] = taken.get(b, 0) + 1
        used = set()
        for b, k in taken.items():
            before = b * (plan.items // plan.blocks) + min(
                b, plan.items % plan.blocks)
            slots = set(range(before * mult, before * mult + k))
            assert not slots & used and max(slots) < plan.slots
            used |= slots


@pytest.mark.parametrize("sizes,n_ranks,quantum",
                         [((700, 3000, 5), 3, 128),
                          ((5000, 37, 9000, 1), 4, 4096),
                          ((301, 77), 2, 6),
                          ((1000, 2000), 2, 64)])
def test_each_items_counter_is_its_group_relative_index(sizes, n_ranks,
                                                        quantum):
    """K3b's counters: an item of tile t from offset o draws its group's
    stream from position start + t·quantum + o − goff[g] on; those words
    are the plain version's (``group_philox_bits``) on the item's
    elements, on every owner's chunk of the layout."""
    lay = group_layout(sizes, n_chunks=n_ranks, quantum=quantum)
    tg_all = lay.tile_groups()
    goff = torch.tensor(lay.offsets, dtype=torch.int64)
    tpc = lay.chunk // quantum
    for j in range(n_ranks):
        tg = torch.from_numpy(tg_all[j * tpc:(j + 1) * tpc])
        src = dq.GroupPhilox(4242, goff, start=j * lay.chunk,
                             group_base=j % 2)
        want = dq.group_philox_bits(src, tg, quantum)
        plan = dq.group_plan(tpc, quantum, len(sizes), 4, 2, False, True)
        for _, _, t, off, ln in _pieces(plan, tpc, quantum):
            g = int(tg[t])
            # the kernel's counter position (start + e - goff[g]) is the
            # element's index in its group: its aligned position less the
            # group's offset
            c = src.start + t * quantum + off - int(goff[g])
            assert c == j * lay.chunk + t * quantum + off - lay.offsets[g]
            got = dq.philox_bits(fold_seed(src.seed, src.group_base + g),
                                 ln, offset=c)
            e = t * quantum + off
            assert torch.equal(got, want[e:e + ln])


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("x_bytes,src", [(4, 0), (2, 1), (4, 2)])
def test_geometry_is_the_plans(stats, x_bytes, src):
    """The geometry function the verifier uses gives the plan's grid,
    threads and shared memory (static only), and the checks accept it; a
    recorded call whose ``nblocks`` is not the plan's fires
    KG-PREFETCH-ARITY."""
    for total, G, q in ((8 * 4096, 4, 4096), (128 * 24576, 128, 24576),
                        (803_385_344, 11, 4096)):
        plan = dq.group_plan(total // q, q, G, x_bytes, src, stats, True)
        geom = ops.group_wire_call_geometry(total, G, q, x_bytes=x_bytes,
                                            src=src, stats=stats)
        assert geom.grid == (plan.blocks,) and geom.threads == plan.threads
        assert geom.smem_bytes == 0
        if total < 1 << 24:          # a wire chunk's map passes the budget
            assert kernel_checks.check_call(geom, expected_groups=G).ok
    from repro_torch.kernels import _build
    sig = _build.KERNEL_SIGNATURES["dps_group_wire_encode"]
    geom = ops.group_wire_call_geometry(8 * 4096, 4, 4096, stats=stats)
    plan = dq.group_plan(8, 4096, 4, 4, 0, stats, True)
    vals = dict(x=1 << 40, x_is_bf16=0, fmt_tab=(1 << 40) + 8192,
                tile_group=(1 << 40) + 8256, bits=None, mask=None, src=0,
                seed=0, goff=None, start=0, group_base=0,
                wire=(1 << 41), partials=None, stats=None, ticket=None,
                tiles=8, quantum=4096, groups=4, nblocks=plan.blocks,
                piece=plan.piece, per=plan.per, run=plan.run, vec=1,
                stream=0)
    args = tuple(vals[a] for a in sig.args)
    check = lambda a: kernel_checks.check_call(
        dataclasses.replace(geom, args=a), expected_groups=4)
    assert check(args).ok
    bad = tuple(plan.blocks + 1 if a == "nblocks" else v
                for a, v in zip(sig.args, args))
    assert check(bad).rules_fired() == ("KG-PREFETCH-ARITY",)
    assert "nblocks" in kernel_checks._GRID_ARGS


def test_plan_refuses_what_no_launch_is():
    for args in ((-1, 16, 1), (4, 0, 1), (4, 16, -1)):
        with pytest.raises(ValueError):
            dq.group_plan(*args)
    with pytest.raises(ValueError):
        dq.group_plan(4, 16, 1, 4, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_encoder_needs_no_mask_on_zeroed_padding(seed):
    """``write_prompt_pages`` zeroes the buffer past the prompt (``x ·
    mask``, so ``-0.0`` where x was negative) and rounds it to nearest
    without statistics: the plain encoder gives the same bytes with the
    mask and without it, through ``encode_pages`` and through the grouped
    wrapper."""
    rng = np.random.default_rng(seed)
    G, E = 6, 64
    x = (rng.standard_normal((G, E)) * 2.0 ** rng.integers(
        -3, 4, (G, 1))).astype(np.float32)
    x[:, ::9] = 0.0
    mask = (rng.random((G, E)) > 0.3).astype(np.float32)
    mask[-1] = 0.0                                  # a page of padding only
    xt = torch.from_numpy(x) * torch.from_numpy(mask)
    assert bool((torch.signbit(xt) & (xt == 0)).any())    # -0.0 present
    mt = torch.from_numpy(mask)
    il = torch.from_numpy(rng.integers(1, 6, G).astype(np.int32))
    fl = (8 - il + torch.from_numpy(rng.integers(0, 3, G).astype(np.int32)))
    fmt = FixedPointFormat(il, fl)
    with_mask = kvc.encode_pages(xt, fmt, mt, backend="plain", quantum=E)
    without = kvc.encode_pages(xt, fmt, None, backend="plain", quantum=E)
    assert torch.equal(with_mask, without)
    assert not bool(without[mt == 0].any())
    tab = torch.stack([il, fl], 1).contiguous()
    tg = torch.arange(G, dtype=torch.int32)
    a, _ = dq.dps_quant_group_wire(xt.reshape(-1), tab, tg, None,
                                   mt.reshape(-1), quantum=E,
                                   emit_stats=False)
    b, _ = dq.dps_quant_group_wire(xt.reshape(-1), tab, tg, None, None,
                                   quantum=E, emit_stats=False)
    assert torch.equal(a, b) and torch.equal(a, without.reshape(-1))
