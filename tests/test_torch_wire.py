"""The port's int8 wire against the JAX package's, and its own contracts.

From the same numpy inputs:

* the codec — ``wire_encode`` with a bits operand and to nearest, scalar and
  ``[G]`` formats, explicit ``group_sizes``, ragged sizes, bf16, NaN, and
  over-wide formats the reference traces (the port's kernel wrapper
  saturates them): wire bytes equal, count/nonzero/overflow/max_abs exact,
  float sums to 1e-6 relative; ``wire_decode`` and the fused reduce against
  ``ref.dps_wire_reduce_ref`` bit for bit;
* the collectives — ``dps_allreduce_mean_tree`` and ``dps_allreduce_mean``
  under nearest rounding, the port on ``StackedTransport(n)``, the reference
  under ``shard_map`` on n forced CPU devices, n ∈ {2, 3, 4}, scalar and
  per-leaf formats, leaves that are not multiples of the quantum: the mean
  bit-equal, the statistics as above.

And the port alone: the group-aligned encode equals the element-wise one,
the tree all-reduce gives the same mean bit for bit at any quantum under
stochastic rounding, and the grouped encoder's plain version counts exactly
past 2^24 elements.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import FixedPointFormat
from repro_torch.dist import (StackedTransport, dps_allreduce_mean,
                              dps_allreduce_mean_tree, psum_stats, wire_decode,
                              wire_encode)
from repro_torch.dist import collectives as coll
from repro_torch.kernels import dps_quant, ops, ref as ref_lib
from test_torch_jaxref import STAT_NAMES, flatten, run_reference, unflatten

EXACT = ("count", "nonzero", "overflow", "max_abs")
SUM_RTOL = 1e-6

_rng = np.random.default_rng(13)


def _x(shape, scale=2.0, zeros=7):
    v = (_rng.standard_normal(shape) * scale).astype(np.float32)
    v.reshape(-1)[::zeros] = 0.0
    return v


def _bits(shape):
    return _rng.integers(0, 2**32, shape, dtype=np.uint32)


def _fmt_arrays(il, fl):
    return {"il": np.asarray(il, np.int32), "fl": np.asarray(fl, np.int32)}


# name -> (arrays, kw)
CODEC = {
    "scalar_bits": ({"x": _x((37, 29)), "bits": _bits((37, 29)),
                     **_fmt_arrays(3, 4)}, {"mode": "stochastic"}),
    "scalar_near": ({"x": _x((1001,)), **_fmt_arrays(2, 6)},
                    {"mode": "nearest"}),
    "scalar_bf16": ({"x": _x((5, 77)), "bits": _bits((5, 77)),
                     **_fmt_arrays(3, 5)}, {"mode": "stochastic", "bf16": True}),
    "group_equal": ({"x": _x((1000,), 1.0), "bits": _bits((1000,)),
                     **_fmt_arrays([2, 3, 1], [6, 5, 7])},
                    {"mode": "stochastic"}),
    "group_sizes_near": ({"x": _x((1000,), 1.0),
                          **_fmt_arrays([2, 1, 3, 2], [6, 7, 4, 5])},
                         {"mode": "nearest", "group_sizes": [500, 37, 400, 63]}),
    "group_sizes_bits": ({"x": _x((20, 50), 1.0), "bits": _bits((20, 50)),
                          **_fmt_arrays([2, 1, 3], [5, 7, 4])},
                         {"mode": "stochastic", "group_sizes": [999, 1, 0]}),
    # IL + FL = 10: the reference traces the format (no capacity check) and
    # saturates; the port's kernel wrapper does the same with any format
    "overwide_traced": ({"x": _x((513,), 6.0), "bits": _bits((513,)),
                         **_fmt_arrays(4, 6)},
                        {"mode": "stochastic", "traced": True}),
    "overwide_group_traced": ({"x": _x((300,), 6.0),
                               **_fmt_arrays([4, 2], [6, 8])},
                              {"mode": "nearest", "traced": True}),
    "nan": ({"x": np.array([np.nan, 1.5, -np.inf, np.inf, np.nan, -0.3, 0.0],
                           np.float32), **_fmt_arrays(3, 5)},
            {"mode": "nearest"}),
}

# the fused reduce: (n, chunk) int8, a [G] FL table, tile map, quantum
REDUCE = {}
for _name, (_n, _chunk, _q, _G) in {"reduce_aligned": (4, 4096, 1024, 3),
                                     "reduce_ragged": (3, 1000, 128, 2),
                                     "reduce_one_rank": (1, 77, 7, 4)}.items():
    _tiles = -(-_chunk // _q)
    REDUCE[_name] = ({"wire": _rng.integers(-128, 127, (_n, _chunk),
                                            dtype=np.int8, endpoint=True),
                      "fl": _rng.integers(0, 8, _G).astype(np.int32),
                      "tile_group": np.sort(_rng.integers(0, _G, _tiles))
                      .astype(np.int32)},
                     {"kind": "reduce", "quantum": _q})


def _tree_shapes():
    return {"a": (7, 13), "b": (4097,), "c": {"d": (300, 5), "e": (1,)},
            "f": (2, 3, 129)}


def _allreduce_cases(n):
    """Per-rank inputs stacked on a leading rank axis."""
    rng = np.random.default_rng(100 + n)
    tree = flatten(_map(_tree_shapes(), lambda s: (
        rng.standard_normal((n,) + s) * 0.4).astype(np.float32)))
    G = len(tree)
    cases = {
        "tree_scalar": ({**{f"tree/{k}": v for k, v in tree.items()},
                         **_fmt_arrays(2, 6)}, {"kind": "tree"}),
        "tree_per_leaf": ({**{f"tree/{k}": v for k, v in tree.items()},
                           **_fmt_arrays(rng.integers(1, 4, G),
                                         np.zeros(G, np.int32))},
                          {"kind": "tree"}),
        "flat_scalar": ({"x": (rng.standard_normal((n, 1001)) * 0.5)
                         .astype(np.float32), **_fmt_arrays(2, 5)},
                        {"kind": "flat"}),
        "flat_groups": ({"x": (rng.standard_normal((n, 2000)) * 0.5)
                         .astype(np.float32),
                         **_fmt_arrays([2, 3, 1], [6, 5, 7])},
                        {"kind": "flat", "group_sizes": [1500, 37, 463]}),
    }
    # per-leaf FL = 8 - IL
    a, kw = cases["tree_per_leaf"]
    a["fl"] = (8 - a["il"]).astype(np.int32)
    return cases


def _map(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map(v, fn) for k, v in shapes.items()}
    return fn(shapes)


NS = (2, 3, 4)
ALLREDUCE = {n: _allreduce_cases(n) for n in NS}


def _arrays(cases):
    return {f"{name}/{k}": v for name, (a, _) in cases.items()
            for k, v in a.items()}


@pytest.fixture(scope="module")
def ref():
    """One reference child per device count, started together."""
    codec = {**CODEC, **REDUCE}
    jobs = {n: [{"job": "allreduce", "tag": f"n{n}",
                 "kw": {"cases": {k: kw for k, (_, kw) in ALLREDUCE[n].items()},
                        "n": n}}]
            for n in NS}
    jobs[2].append({"job": "wire_codec", "tag": "codec",
                    "kw": {"cases": {k: kw for k, (_, kw) in codec.items()}}})
    arrays = {n: {f"n{n}/{k}": v for k, v in _arrays(ALLREDUCE[n]).items()}
              for n in NS}
    arrays[2].update({f"codec/{k}": v for k, v in _arrays(codec).items()})
    with concurrent.futures.ThreadPoolExecutor(len(NS)) as pool:
        futs = [pool.submit(run_reference, jobs[n], arrays[n], 900, n)
                for n in NS]
        out = {}
        for f in futs:
            out.update(f.result())
    return out


def _t(a):
    # np.array keeps a 0-d array 0-d (np.ascontiguousarray would not)
    return torch.from_numpy(np.array(a))


def _fmt(a):
    return FixedPointFormat(_t(a["il"]), _t(a["fl"]))


def _hold_stats(s, ref, prefix):
    for k in STAT_NAMES:
        got = getattr(s, k).numpy()
        want = ref[f"{prefix}{k}"]
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL, err_msg=k)


def _encode(a, kw, **extra):
    x = _t(a["x"])
    if kw.get("bf16"):
        x = x.to(torch.bfloat16)
    bits = _t(a["bits"].view(np.int32)) if kw["mode"] == "stochastic" else None
    return x, bits, _fmt(a), kw.get("group_sizes")


@pytest.mark.parametrize("name", sorted(CODEC))
def test_wire_codec_matches_reference(ref, name):
    a, kw = CODEC[name]
    x, bits, fmt, gs = _encode(a, kw)
    p = f"codec/{name}/"
    if kw.get("traced"):
        # what the kernel wrapper does with a format on the device
        if fmt.il.ndim == 0:
            w, s = ops.dps_quantize_wire(x, fmt, bits.reshape(-1)
                                         if bits is not None else None)
        else:
            layout = coll.group_layout(
                coll._equal_group_sizes(x.numel(), fmt.il.shape[0]),
                quantum=128)
            tg, _ = coll._layout_tables(layout, "cpu")
            w_al, s = coll._encode_aligned(
                layout.align(x.reshape(-1)), fmt, tg,
                coll._layout_mask(layout, "cpu"), mode=kw["mode"],
                backend="plain", quantum=128)
            w = layout.dealign(w_al)
        with pytest.raises(ValueError, match="exceeds the int8 wire"):
            wire_encode(x, fmt, bits=bits, mode=kw["mode"])
    else:
        w, s = wire_encode(x, fmt, bits=bits, mode=kw["mode"], group_sizes=gs)
    np.testing.assert_array_equal(w.numpy(), ref[p + "wire"])
    _hold_stats(s, ref, p)
    dec = wire_decode(w, fmt, group_sizes=gs)
    np.testing.assert_array_equal(dec.numpy(), ref[p + "decoded"])
    if fmt.il.ndim == 0:
        w2, v = ref_lib.dps_quant_wire_ref(x, fmt.il, fmt.fl, bits,
                                           mode=kw["mode"])
        np.testing.assert_array_equal(w2.numpy(), ref[p + "ref_wire"])
        np.testing.assert_array_equal(w2.numpy(), w.numpy())
        np.testing.assert_array_equal(v.numpy()[[0, 1, 2, 6]],
                                      ref[p + "ref_vec"][[0, 1, 2, 6]])
    if name == "nan":
        # NaN is written as the byte 0 by both packages, and counted as
        # overflow (k != sat holds for NaN)
        assert list(w.numpy()[[0, 4]]) == [0, 0]
        assert float(s.overflow) == 2.0 + 2.0


@pytest.mark.parametrize("name", sorted(
    k for k, (a, kw) in CODEC.items()
    if np.ndim(a["il"]) == 1 and not kw.get("traced")))
def test_aligned_encode_equals_the_elementwise_one(name):
    """The kernel backend's route — the group-aligned layout and the grouped
    encoder's per-tile version — gives the element-wise route's bytes and
    statistics (run here with the plain version of the grouped encoder)."""
    a, kw = CODEC[name]
    x, bits, fmt, gs = _encode(a, kw)
    sizes = gs or coll._equal_group_sizes(x.numel(), fmt.il.shape[0])
    w1, s1 = wire_encode(x, fmt, bits=bits, mode=kw["mode"], group_sizes=gs)
    for quantum in (128, 7):
        w2, s2 = coll._wire_encode_aligned(x, fmt, sizes, bits, None,
                                           mode=kw["mode"], compute_stats=True,
                                           backend="plain", quantum=quantum)
        assert torch.equal(w1, w2)
        for k in STAT_NAMES:
            a1, a2 = getattr(s1, k), getattr(s2, k)
            if k in EXACT:
                assert torch.equal(a1, a2), k
            else:
                torch.testing.assert_close(a1, a2, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("name", sorted(REDUCE))
def test_wire_reduce_matches_reference_bit_for_bit(ref, name):
    a, kw = REDUCE[name]
    wire, fl, tg = _t(a["wire"]), _t(a["fl"]), _t(a["tile_group"])
    want = ref[f"codec/{name}/mean"]
    got = ref_lib.dps_wire_reduce_ref(wire, fl, tg, kw["quantum"])
    np.testing.assert_array_equal(got.numpy(), want)
    fmt = FixedPointFormat(torch.zeros_like(fl), fl)
    m = coll._wire_reduce(wire, fmt, tg, backend="plain",
                          quantum=kw["quantum"])
    np.testing.assert_array_equal(m.numpy(), want)
    # a strided view of the rows gives the same mean
    pad = torch.zeros(wire.shape[0], wire.shape[1] + 9, dtype=torch.int8)
    pad[:, :wire.shape[1]] = wire
    m2 = coll._wire_reduce(pad[:, :wire.shape[1]], fmt, tg, backend="plain",
                           quantum=kw["quantum"])
    assert torch.equal(m, m2)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", ["tree_scalar", "tree_per_leaf",
                                  "flat_scalar", "flat_groups"])
def test_allreduce_matches_shard_map_reference(ref, n, name):
    """The port on ``StackedTransport(n)`` against the reference under
    ``shard_map`` on n devices, nearest rounding: the mean bit-equal, the
    psum'ed dispatch-leg statistics exact (counts, max) and to 1e-6."""
    a, kw = ALLREDUCE[n][name]
    fmt = _fmt(a)
    tr = StackedTransport(n)
    p = f"n{n}/{name}/"
    if kw["kind"] == "tree":
        stacked = unflatten({k: v for k, v in a.items()}, "tree/")
        trees = [_map(stacked, lambda v, r=r: _t(v[r])) for r in range(n)]
        mean, st = dps_allreduce_mean_tree(trees, fmt, tr, 0, mode="nearest")
        for k, v in flatten(_map(mean, lambda t: t.numpy())).items():
            np.testing.assert_array_equal(v, ref[f"{p}mean/{k}"], err_msg=k)
    else:
        xs = [_t(a["x"][r]) for r in range(n)]
        mean, st = dps_allreduce_mean(xs, fmt, tr, 0, mode="nearest",
                                      group_sizes=kw.get("group_sizes"))
        np.testing.assert_array_equal(mean.numpy(), ref[p + "mean"])
    _hold_stats(psum_stats(st, tr), ref, p)


def _stochastic_trees(n, seed=5):
    # inside every leaf's range (|x| < 2^(IL-1) for IL >= 1): no clipping
    rng = np.random.default_rng(seed)
    return [_map(_tree_shapes(), lambda s: torch.from_numpy(
        rng.uniform(-0.9, 0.9, s).astype(np.float32))) for _ in range(n)]


def test_tree_allreduce_is_layout_invariant_under_stochastic_rounding():
    """Leg-2 bits are keyed by (seed, leaf, element in the leaf), so the mean
    is the same bit for bit at quantum 4096 and at the size-aware quantum
    (and at an odd one)."""
    trees = _stochastic_trees(3)
    fmt = FixedPointFormat(torch.tensor([2, 1, 3, 2, 1], dtype=torch.int32),
                           torch.tensor([6, 7, 5, 6, 7], dtype=torch.int32))
    size = sum(v.size for v in flatten(trees[0]).values())
    assert coll.default_wire_quantum(size, 5) != 4096
    tr = StackedTransport(3)
    means = [flatten(_map(dps_allreduce_mean_tree(
        trees, fmt, tr, 99, mode="stochastic", quantum=q)[0],
        lambda t: t.numpy())) for q in (4096, None, 7)]
    for m in means[1:]:
        for k, v in m.items():
            np.testing.assert_array_equal(v, means[0][k], err_msg=k)
    # and the stochastic mean is not the nearest one (bits were drawn)
    near = dps_allreduce_mean_tree(trees, fmt, tr, 99, mode="nearest")[0]
    assert not np.array_equal(near["b"].numpy(), means[0]["b"])


def test_tree_allreduce_stochastic_is_unbiased_within_two_grid_steps():
    """Each leg's error is below one grid step: the mean is within two of
    the fp32 mean, leaf by leaf at that leaf's FL."""
    n = 4
    trees = _stochastic_trees(n, seed=6)
    fls = [6, 7, 5, 6, 7]
    fmt = FixedPointFormat(torch.tensor([2, 1, 3, 2, 1], dtype=torch.int32),
                           torch.tensor(fls, dtype=torch.int32))
    mean, _ = dps_allreduce_mean_tree(trees, fmt, StackedTransport(n), 3)
    names = ["a", "b", "c/d", "c/e", "f"]
    flat = flatten(_map(mean, lambda t: t.numpy()))
    for g, k in enumerate(names):
        exact = sum(flatten(_map(t, lambda v: v.numpy()))[k]
                    for t in trees) / n
        assert np.abs(flat[k] - exact).max() < 2 * 2.0 ** -fls[g] + 1e-6, k


def test_leg2_streams_are_keyed_per_group_and_element():
    """K3b's plain version: the words of an owner's chunk are the group
    streams at the elements' indices in their groups, whatever the chunk."""
    lay = coll.group_layout((300, 77, 1000), n_chunks=3, quantum=64)
    tg, goff = coll._layout_tables(lay, "cpu")
    full = dps_quant.group_philox_bits(dps_quant.GroupPhilox(7, goff), tg, 64)
    for j in range(3):
        tpc = lay.chunk // 64
        part = dps_quant.group_philox_bits(
            dps_quant.GroupPhilox(7, goff, start=j * lay.chunk),
            tg[j * tpc:(j + 1) * tpc], 64)
        assert torch.equal(part, full[j * lay.chunk:(j + 1) * lay.chunk])
    for g, (off, size) in enumerate(zip(lay.offsets, lay.group_sizes)):
        want = dps_quant.philox_bits(coll.fold_seed(7, g), size)
        assert torch.equal(full[off:off + size], want)


def test_grouped_encoder_counts_exactly_past_2_24():
    """A group of 2^24 + 3 elements through the grouped encoder's plain
    version, one element a tile, nearest rounding onto ⟨1, 0⟩: every element
    overflows and is nonzero.  Summed as float32 the counts would stop at
    2^24; they are integers until the final cast."""
    n = (1 << 24) + 3
    x = -1.5 - torch.rand(n, generator=torch.Generator().manual_seed(0))
    tab = torch.tensor([[1, 0]], dtype=torch.int32)
    tg = torch.zeros(n, dtype=torch.int32)
    _, stats = dps_quant.dps_quant_group_wire(x, tab, tg, quantum=1)
    want = float(np.float32(n))
    assert want != float(1 << 24)
    assert stats[0, :3].tolist() == [want, want, want]


def test_wire_kernel_backend_on_a_cpu_tensor_raises():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        dps_quant.dps_quant_wire(x, torch.tensor(2, dtype=torch.int32),
                                 torch.tensor(6, dtype=torch.int32),
                                 backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        dps_quant.dps_wire_reduce(torch.zeros(2, 16, dtype=torch.int8),
                                  torch.tensor([[2, 6]], dtype=torch.int32),
                                  quantum=16, backend="kernel")
    assert dps_quant.wire_launch_count == dps_quant.reduce_launch_count == 0


@pytest.mark.parametrize("bad", ["dtype", "rows", "tile_group", "table"])
def test_wire_reduce_wrapper_checks_its_arguments(bad):
    wire = torch.zeros(3, 40, dtype=torch.int8)
    tab = torch.tensor([[2, 6], [3, 5]], dtype=torch.int32)
    tg = torch.zeros(5, dtype=torch.int32)
    err = TypeError
    if bad == "dtype":
        wire = wire.to(torch.int16)
    elif bad == "rows":
        wire, err = wire.t().contiguous().t(), ValueError
    elif bad == "tile_group":
        tg = tg[:4]
    else:
        tab = tab.to(torch.int64)
    with pytest.raises(err):
        dps_quant.dps_wire_reduce(wire, tab, tg, quantum=8)


def test_wire_encode_takes_its_bits_from_philox_streams():
    """A seed draws the Philox stream of the kernels: scalar formats one
    stream over the tensor, [G] formats one per group at the element's index
    in the group — the same words a bits operand would carry."""
    x = torch.from_numpy(_x((1000,), 1.0))
    fmt = FixedPointFormat.create(2, 6)
    a, _ = wire_encode(x, fmt, seed=11)
    b, _ = wire_encode(x, fmt, bits=dps_quant.philox_bits(11, 1000))
    assert torch.equal(a, b)
    g = FixedPointFormat(torch.tensor([2, 3], dtype=torch.int32),
                         torch.tensor([6, 5], dtype=torch.int32))
    sizes = (600, 400)
    a, _ = wire_encode(x, g, seed=11, group_sizes=sizes)
    bits = torch.cat([dps_quant.philox_bits(coll.fold_seed(11, i), s)
                      for i, s in enumerate(sizes)])
    b, _ = wire_encode(x, g, bits=bits, group_sizes=sizes)
    assert torch.equal(a, b)
    c, _ = coll._wire_encode_aligned(x, g, sizes, None, 11, mode="stochastic",
                                     compute_stats=False, backend="plain",
                                     quantum=128)
    assert torch.equal(a, c)


@pytest.mark.parametrize("onchip_prng", [True, False])
def test_grouped_allreduce_is_layout_invariant_with_either_bit_source(
        onchip_prng):
    """Philox in the kernel (K2b/K3b) or a bits operand (K2/K3): the tree
    all-reduce and the grouped flat one give the same mean bit for bit at
    any quantum, within two grid steps of the fp32 mean."""
    trees = _stochastic_trees(3, seed=8)
    fls = [6, 7, 5, 6, 7]
    fmt = FixedPointFormat(torch.tensor([2, 1, 3, 2, 1], dtype=torch.int32),
                           torch.tensor(fls, dtype=torch.int32))
    tr = StackedTransport(3)
    means = [flatten(_map(dps_allreduce_mean_tree(
        trees, fmt, tr, 99, mode="stochastic", quantum=q,
        onchip_prng=onchip_prng)[0], lambda t: t.numpy()))
        for q in (4096, None, 7)]
    for m in means[1:]:
        for k, v in m.items():
            np.testing.assert_array_equal(v, means[0][k], err_msg=k)
    for g, k in enumerate(["a", "b", "c/d", "c/e", "f"]):
        exact = sum(flatten(_map(t, lambda v: v.numpy()))[k]
                    for t in trees) / 3
        assert np.abs(means[0][k] - exact).max() < 2 * 2.0 ** -fls[g] + 1e-6
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(rng.uniform(-0.9, 0.9, 2000).astype(np.float32))
          for _ in range(3)]
    gfmt = FixedPointFormat(torch.tensor([2, 3, 1], dtype=torch.int32),
                            torch.tensor([6, 5, 7], dtype=torch.int32))
    flat = [dps_allreduce_mean(xs, gfmt, tr, 5, mode="stochastic",
                               group_sizes=(1500, 37, 463), quantum=q,
                               onchip_prng=onchip_prng)[0]
            for q in (4096, None, 7)]
    assert all(torch.equal(f, flat[0]) for f in flat[1:])
    assert float((flat[0] - sum(xs) / 3).abs().max()) < 2 * 2.0 ** -5


def test_operand_wire_draws_each_leaf_stream_whole():
    """With a bits operand, rank r's leaf g takes ``operand_bits`` of
    ``fold_seed(fold_seed(seed, r), g)`` over the whole leaf on leg 1, and
    leg 2's words over any owner chunk are the slices of each group's
    ``operand_bits`` stream at the elements' indices in the group."""
    trees = _stochastic_trees(2, seed=10)
    fmt = FixedPointFormat.create(2, 6)
    tw = coll.TreeAllReduce(trees[0], fmt, StackedTransport(2), 41,
                            onchip_prng=False)
    tw.encode(1, trees[1])
    for g, leaf in enumerate(tree_lib.leaves(trees[1])):
        off, size = tw.offsets[g], leaf.numel()
        bits = ops.operand_bits(coll.fold_seed(coll.fold_seed(41, 1), g),
                                size, "cpu")
        want, _ = wire_encode(leaf, fmt, bits=bits)
        assert torch.equal(tw.payload[1, off:off + size],
                           want.reshape(-1)), g
    lay = coll.group_layout((300, 77, 1000), n_chunks=3, quantum=64)
    _, goff = coll._layout_tables(lay, "cpu")
    full = coll._aligned_bits(7, lay, goff, 0, lay.total, onchip_prng=False)
    for j in range(3):
        part = coll._aligned_bits(7, lay, goff, j * lay.chunk, lay.chunk,
                                  onchip_prng=False)
        assert torch.equal(part, full[j * lay.chunk:(j + 1) * lay.chunk])
    valid = torch.from_numpy(lay.mask()) > 0
    assert not bool(full[~valid].any())
    for g, (off, size) in enumerate(zip(lay.offsets, lay.group_sizes)):
        want = ops.operand_bits(coll.fold_seed(7, g), size, "cpu")
        assert torch.equal(full[off:off + size], want)
