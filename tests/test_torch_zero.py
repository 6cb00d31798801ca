"""ZeRO-1 in the port: its flat layouts, its half-collectives, its step.

* Geometry: ``ZeroPartitioner`` and ``GroupAlignedPartitioner`` against the
  reference's for the same leaf shapes, with an explicit quantum (the port
  rounds its default quantum to 16 elements, the reference's jnp codec to
  128, so the default layouts differ in length; results do not): the 37/8
  case, leaves smaller than a quantum, a single leaf, bucketed runs —
  every size and offset equal.  Round trips flatten → shard → assemble →
  unflatten bit-exact; ``flat_view`` leaves alias the flat buffer.
* The ZeRO halves (``dps_reduce_scatter_mean``, ``dps_allgather_params``,
  ``zero_bucketed_reduce_scatter``, ``zero_allgather_params``) under
  nearest rounding on ``StackedTransport(4)`` against the reference under
  ``shard_map`` on 4 forced CPU devices: values bit-equal, count, nonzero,
  overflow and max_abs exact, float sums to 1e-6 relative.  Each owner's
  reduce-scatter shard is bit-equal to its chunk of the all-reduce's mean
  under both rounding modes and both bit sources.
* The step: ZeRO (group-aligned, with and without the overlap and with
  several buckets) against the wire step, bit for bit over 3 steps under
  nearest and stochastic rounding, with the reference's policy-excluded
  ``norm_scale`` MLP (the params leg stays fp32, the regime in which the
  two are defined to coincide); ``bits=None`` ZeRO against the replicated
  step; a fully quantized MLP (int8 params leg) against the reference's
  ZeRO step; two gloo processes against ``StackedTransport(2)``; the
  engagement policy; the launch counts the card is held to.
"""

import dataclasses
import multiprocessing as mp
import warnings

import numpy as np
import pytest
import torch

from repro_torch.convert import zero_opt_state_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import FixedPointFormat
from repro_torch.dist import (GroupAlignedPartitioner, ProcessGroupTransport,
                              StackedTransport, ZeroPartitioner,
                              dps_allgather_params, dps_allreduce_mean,
                              dps_allreduce_mean_tree,
                              dps_reduce_scatter_mean, psum_stats,
                              zero_allgather_params,
                              zero_bucketed_reduce_scatter)
from repro_torch.models.common import rms_norm
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer
from repro_torch.optim.optimizers import shard_sq_norm
from repro_torch.resilience import GuardConfig
from test_torch_jaxref import STAT_NAMES, run_reference, unflatten

EXACT = ("count", "nonzero", "overflow", "max_abs")
SUM_RTOL = 1e-6
N = 4

GEOMETRY = {
    "n37": {"shapes": [[37]], "n": 8, "quantum": 8},
    "small": {"shapes": [[3], [5, 1], [7], []], "n": 8, "quantum": 16},
    "single": {"shapes": [[10, 100]], "n": 8, "quantum": 128},
    "bucketed": {"shapes": [[640], [96], [32], [7]], "n": 8, "quantum": 32,
                 "buckets": [[0], [1, 2], [3]]},
    "bucketed_q16": {"shapes": [[16, 37], [37], [37, 8]], "n": 3,
                     "quantum": 16, "buckets": [[2], [0, 1]]},
    "plain37": {"shapes": [[37]], "n": 8},
    "plain_mixed": {"shapes": [[16, 37], [37], [37, 8], []], "n": 8},
}

_rng = np.random.default_rng(21)


def _x(shape, scale=0.5):
    return np.asarray(_rng.standard_normal(shape) * scale, np.float32)


def _fmt_arrays(il, fl):
    return {"il": np.asarray(il, np.int32), "fl": np.asarray(fl, np.int32)}


def _fmt(case):
    return FixedPointFormat(torch.as_tensor(case["il"], dtype=torch.int32),
                            torch.as_tensor(case["fl"], dtype=torch.int32))


# the ragged tree of the halves (per rank), and a partitioner's buckets
TREE_SHAPES = {"a": (7, 13), "b": (300,), "c": {"d": (2, 3, 40), "e": (1,)}}
TREE_BUCKETS = [[0], [1, 2], [3]]
Q = 16


def _tree_arrays():
    out = {}
    for leaf_path, shape in tree_lib.leaves_with_path(TREE_SHAPES):
        out["/".join(leaf_path)] = _x((N,) + tuple(shape))
    return out


def _aligned_part(buckets):
    like = tree_lib.map_tree(lambda s: torch.empty(s), TREE_SHAPES)
    return GroupAlignedPartitioner.create(like, N, quantum=Q, buckets=buckets)


def _halves_cases():
    cases, arrays = {}, {}
    tree = _tree_arrays()
    for name, fmt in (("scalar", _fmt_arrays(2, 6)),
                      ("leaf", _fmt_arrays([2, 1, 3, 2], [6, 7, 5, 6]))):
        cases[f"rs_{name}"] = {"kind": "rs"}
        arrays[f"rs_{name}/x"] = _x((N, 1001))
        arrays.update({f"rs_{name}/{k}": v for k, v in
                       (fmt if name == "scalar"
                        else _fmt_arrays([2, 1, 3], [6, 7, 5])).items()})
        cases[f"ag_{name}"] = {"kind": "ag"}
        arrays[f"ag_{name}/x"] = _x((N, 251), 1.0)
        arrays.update({f"ag_{name}/{k}": v for k, v in fmt.items()})
        for bname, bk in (("one", None), ("three", TREE_BUCKETS)):
            c = f"zrs_{name}_{bname}"
            cases[c] = {"kind": "zrs", "quantum": Q, "buckets": bk}
            arrays.update({f"{c}/tree/{k}": v for k, v in tree.items()})
            arrays.update({f"{c}/like/{k}": v for k, v in tree.items()})
            arrays.update({f"{c}/{k}": v for k, v in fmt.items()})
            c = f"zag_{name}_{bname}"
            cases[c] = {"kind": "zag", "quantum": Q, "buckets": bk}
            arrays[f"{c}/x"] = _x((N, _aligned_part(bk).shard_size), 1.0)
            arrays.update({f"{c}/like/{k}": v for k, v in tree.items()})
            arrays.update({f"{c}/{k}": v for k, v in fmt.items()})
    return cases, arrays


HALVES, HALVES_ARRAYS = _halves_cases()

# the fully quantized MLP of the int8 params leg
MLP_SHAPES = {"w1": (16, 24), "b1": (24,), "w2": (24, 8)}
MLP_STEPS = 3


def _mlp_arrays():
    rng = np.random.default_rng(5)
    out = {f"params/{k}": (rng.standard_normal(s) * 0.3).astype(np.float32)
           for k, s in MLP_SHAPES.items()}
    out["x"] = rng.standard_normal((32, 16)).astype(np.float32)
    out["y"] = rng.standard_normal((32, 8)).astype(np.float32)
    return out


MLP_ARRAYS = _mlp_arrays()


@pytest.fixture(scope="module")
def ref():
    arrays = {f"zh/{k}": v for k, v in HALVES_ARRAYS.items()}
    arrays.update({f"mlp/{k}": v for k, v in MLP_ARRAYS.items()})
    return run_reference(
        [{"job": "zero_geometry", "tag": "geo", "kw": {"cases": GEOMETRY}},
         {"job": "zero_halves", "tag": "zh",
          "kw": {"cases": HALVES, "n": N}},
         {"job": "zero_mlp_train", "tag": "mlp",
          "kw": {"steps": MLP_STEPS, "n": N}}],
        arrays, host_devices=N)


def _shape_tree(shapes):
    return {f"l{i:02d}": torch.zeros(tuple(s)) for i, s in enumerate(shapes)}


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_partitioner_geometry_matches_the_reference(ref, name):
    c = GEOMETRY[name]
    tree = _shape_tree(c["shapes"])
    want = ref[f"geo/{name}/sizes"]
    if c.get("quantum") is None:
        part = ZeroPartitioner.create(tree, c["n"])
        assert [part.size, part.shard_size, part.padded_size] == list(want)
        return
    part = GroupAlignedPartitioner.create(tree, c["n"], quantum=c["quantum"],
                                         buckets=c.get("buckets"))
    assert [part.size, part.shard_size, part.padded_size,
            part.n_buckets] == list(want)
    B, G = part.n_buckets, len(c["shapes"])
    assert [part.bucket_offset(b) for b in range(B)] == list(
        ref[f"geo/{name}/bucket_offset"])
    assert [part.shard_offset(b) for b in range(B)] == list(
        ref[f"geo/{name}/shard_offset"])
    assert [list(part.leaf_range(b)) for b in range(B)] == \
        ref[f"geo/{name}/leaf_range"].tolist()
    assert [part.leaf_offset(g) for g in range(G)] == list(
        ref[f"geo/{name}/leaf_offset"])
    # the aligned invariants the collectives rely on
    for b, lay in enumerate(part.layouts):
        assert lay.chunk % lay.quantum == 0
        assert part.bucket_offset(b) % lay.quantum == 0


def _parts(tree, n):
    yield ZeroPartitioner.create(tree, n)
    yield GroupAlignedPartitioner.create(tree, n)
    G = len(tree_lib.leaves(tree))
    yield GroupAlignedPartitioner.create(
        tree, n, quantum=16, buckets=[(g,) for g in range(G)])


@pytest.mark.parametrize("name", ["n37", "small", "single", "bucketed",
                                  "bucketed_q16"])
def test_round_trips_are_bit_exact(name):
    c = GEOMETRY[name]
    tree = {k: torch.from_numpy(_x(tuple(v.shape), 3.0)).reshape(v.shape)
            for k, v in _shape_tree(c["shapes"]).items()}
    for part in _parts(tree, c["n"]):
        flat = part.flatten(tree)
        assert flat.shape == (part.padded_size,)
        assert part.padded_size == part.n_shards * part.shard_size
        back = part.unflatten(flat)
        for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(back)):
            assert torch.equal(a, b)
        shards = torch.stack([part.shard(flat, j)
                              for j in range(part.n_shards)])
        assert torch.equal(part.assemble(shards), flat)
        # a shard built from the leaves is the flat vector's shard
        for j in range(part.n_shards):
            assert torch.equal(part.shard_from_tree(tree, j), shards[j])
        # padding is zero
        mask = torch.zeros(part.padded_size, dtype=torch.bool)
        for g, leaf in enumerate(tree_lib.leaves(tree)):
            mask[part.leaf_offset(g):part.leaf_offset(g) + leaf.numel()] = True
        assert not flat[~mask].any()


def test_flat_views_alias_the_flat_buffer():
    tree = {"a": torch.randn(5, 7), "b": torch.randn(3), "c": torch.randn(())}
    for part in _parts(tree, 4):
        flat, views = part.flat_view(tree)
        assert part.flat_of(views).data_ptr() == flat.data_ptr()
        assert part.flat_of(tree) is None
        views["a"].add_(1.0)                         # through a leaf ...
        assert torch.equal(part.unflatten(flat)["a"], tree["a"] + 1.0)
        part.shard_segments(flat, 1)[0].mul_(0.0)    # ... and a shard
        assert torch.equal(part.unflatten(flat)["b"], views["b"])
    with pytest.raises(TypeError, match="fp32"):
        ZeroPartitioner.create({"x": torch.zeros(3, dtype=torch.bfloat16)},
                               2).flat_view({"x": torch.zeros(
                                   3, dtype=torch.bfloat16)})


def test_malformed_buckets_are_rejected():
    tree = {"a": torch.ones(4), "b": torch.ones(4)}
    with pytest.raises(ValueError):                   # leaf 1 dropped
        GroupAlignedPartitioner.create(tree, 4, buckets=((0,),))
    with pytest.raises(ValueError):                   # a leaf twice
        GroupAlignedPartitioner.create(tree, 4, buckets=((0,), (0, 1)))
    with pytest.raises(ValueError):
        ZeroPartitioner.create(tree, 0)


# ---------------------------------------------------------------------------
# the ZeRO halves against the reference
# ---------------------------------------------------------------------------

def _check_stats(ref, p, st, n_what):
    for k in STAT_NAMES:
        got = getattr(st, k).numpy()
        want = ref[p + k]
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f"{n_what} {k}")
        else:
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL,
                                       err_msg=f"{n_what} {k}")


@pytest.mark.parametrize("name", sorted(HALVES))
def test_zero_halves_match_the_shard_map_reference(ref, name):
    c, p = HALVES[name], f"zh/{name}/"
    arr = {k[len(name) + 1:]: v for k, v in HALVES_ARRAYS.items()
           if k.startswith(name + "/")}
    fmt = _fmt(arr)
    tr = StackedTransport(N)
    kind = c["kind"]
    if kind == "rs":
        xs = [torch.from_numpy(arr["x"][r]) for r in range(N)]
        out, st = dps_reduce_scatter_mean(xs, fmt, tr, 0, mode="nearest")
        want = ref[p + "out"]
    elif kind == "ag":
        xs = [torch.from_numpy(arr["x"][r]) for r in range(N)]
        out, st = dps_allgather_params(xs, fmt, tr, 0, mode="nearest")
        out = out[None].expand(N, -1)          # the same on every rank
        want = ref[p + "out"]
    elif kind == "zrs":
        part = _aligned_part(c["buckets"])
        tree = unflatten(arr, "tree/")
        trees = [tree_lib.map_tree(lambda v: torch.from_numpy(v[r]), tree)
                 for r in range(N)]
        out, st = zero_bucketed_reduce_scatter(trees, fmt, tr, 0, part=part,
                                               mode="nearest")
        want = ref[p + "out"]
    else:
        part = _aligned_part(c["buckets"])
        xs = [torch.from_numpy(arr["x"][r]) for r in range(N)]
        out, st = zero_allgather_params(xs, fmt, tr, 0, part=part,
                                        mode="nearest")
        out = out[None].expand(N, -1)
        want = ref[p + "out"]
    assert tuple(out.shape) == want.shape, name
    np.testing.assert_array_equal(out.numpy(), want, err_msg=name)
    _check_stats(ref, p, psum_stats(st, tr), name)


@pytest.mark.parametrize("mode,onchip", [("nearest", True),
                                         ("stochastic", True),
                                         ("stochastic", False)])
@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("buckets", [None, TREE_BUCKETS])
def test_owner_shards_are_their_chunks_of_the_allreduce_mean(
        mode, onchip, per_leaf, buckets):
    """The reduce-scatter's leg-2 snap decoded locally is the all-reduce's
    mean, element for element: owner j's shard is ``part.shard`` of the
    flattened mean."""
    tree = _tree_arrays()
    trees = [tree_lib.map_tree(lambda v: torch.from_numpy(v[r]),
                               unflatten(tree, "")) for r in range(N)]
    fmt = (FixedPointFormat(torch.tensor([2, 1, 3, 2], dtype=torch.int32),
                            torch.tensor([6, 7, 5, 6], dtype=torch.int32))
           if per_leaf else FixedPointFormat.create(2, 6))
    tr = StackedTransport(N)
    part = _aligned_part(buckets)
    mean, st_m = dps_allreduce_mean_tree(trees, fmt, tr, 99, mode=mode,
                                         onchip_prng=onchip)
    shards, st_z = zero_bucketed_reduce_scatter(trees, fmt, tr, 99, part=part,
                                                mode=mode, onchip_prng=onchip)
    flat = part.flatten(mean)
    for j in range(N):
        assert torch.equal(shards[j], part.shard(flat, j)), j
    for a, b in zip(st_m, st_z):
        for k in STAT_NAMES:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("onchip", [True, False])
def test_scalar_reduce_scatter_is_the_allreduce_dispatch_leg(onchip):
    """Under stochastic rounding the scalar reduce-scatter's dispatch leg is
    the one-leaf all-reduce's: the same streams, so the same statistics.
    Each owner's shard (K4's mean, before the all-reduce's second snap:
    finer than the grid) lies within one grid step of the exact mean, the
    all-reduce's mean within one step of the shard, and the padding past
    the vector is zero."""
    rng = np.random.default_rng(5)
    size = 1001                                   # not a multiple of N
    xs = [torch.from_numpy(rng.uniform(-1, 1, size).astype(np.float32))
          for _ in range(N)]
    fmt = FixedPointFormat.create(2, 6)
    tr = StackedTransport(N)
    shards, st_rs = dps_reduce_scatter_mean(xs, fmt, tr, 7, onchip_prng=onchip)
    mean, st_ar = dps_allreduce_mean(xs, fmt, tr, 7, onchip_prng=onchip)
    for a, b in zip(st_rs, st_ar):
        for k in STAT_NAMES:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert tuple(shards.shape) == (N, -(-size // N))
    got = shards.reshape(-1)
    assert not got[size:].any()
    step = 2.0 ** -6
    exact = torch.stack(xs).double().mean(0)
    assert float((got[:size].double() - exact).abs().max()) < step
    assert float((mean - got[:size]).abs().max()) < step
    # K4's mean is a sum of N grid integers over N: finer than the grid,
    # so it is not the all-reduce's (snapped) mean
    k = got * (N / step)
    assert torch.equal(k, k.round())
    assert not torch.equal(mean, got[:size])


def test_dps_halves_reject_an_explicit_kernel_for_group_formats():
    fmt = FixedPointFormat(torch.tensor([2, 3], dtype=torch.int32),
                           torch.tensor([6, 5], dtype=torch.int32))
    tr = StackedTransport(2)
    xs = [torch.zeros(10), torch.zeros(10)]
    with pytest.raises(ValueError, match="per-element"):
        dps_reduce_scatter_mean(xs, fmt, tr, 0, backend="kernel")
    with pytest.raises(ValueError, match="per-element"):
        dps_allgather_params(xs, fmt, tr, 0, backend="kernel")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _norm_mlp_loss(params, batch, qctx=None):
    h = rms_norm(batch["x"] @ params["w1"], params["norm_scale"])
    return torch.mean((h @ params["w2"] - batch["y"]) ** 2), {}


def _norm_mlp():
    """The reference's parity model: ``norm_scale`` is policy-excluded, so
    the params leg stays fp32; w1 is 16x37, the non-divisible slot."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    params = {"w1": f(16, 37) * 0.3, "norm_scale": torch.ones(37),
              "w2": f(37, 8) * 0.3}
    batch = {"x": f(32, 16), "y": f(32, 8)}
    return params, batch


def _run_steps(loss_fn, params, batch, opt, qcfg, n, steps=3, accum=1):
    params = {k: v.clone() for k, v in params.items()}
    tr = StackedTransport(n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step = qtrain.make_train_step(loss_fn, opt, qcfg, accum_steps=accum,
                                      transport=tr)
        opt_state = (qtrain.zero_opt_state(opt, params, tr, qcfg)
                     if step.zero_opt_active else opt.init(params))
        state = qtrain.TrainState.create(params, opt_state, qcfg, 3)
        hist = []
        for _ in range(steps):
            state, m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items()})
    return state, hist, step


def _assert_same_run(a, b):
    """Parameters, losses, every domain's formats, the wire statistics and
    the controllers' states bit for bit — what the reference's parity test
    holds.  Not the compute domains' E and R: under stochastic rounding the
    wire step's optimizer-input snap of its mean (which a ZeRO step with
    an fp32 params leg skips, as the reference's does) is not the identity
    on grid values — ``floor(k + u)`` in fp32 rounds up when ``k`` is large
    and ``u`` near 1 — and moves a pre-snap weight by an ulp that the
    re-snap hides but E_w sees."""
    (sa, ha, _), (sb, hb, _) = a, b
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
    for x, y in zip(ha, hb):
        for k in x:
            if ("wire_params" not in k and k in y
                    and not k.startswith(("E_", "R_"))) or k.endswith("wire"):
                assert x[k] == y[k], k
    # the controllers saw the same statistics: equal states
    for name, st in sa.dps.items():
        if name == "wire_params":       # only ZeRO has the params leg
            continue
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(st, f.name),
                               getattr(sb.dps[name], f.name)), (name, f.name)


SGD_PARITY = SGDConfig(lr=0.01, momentum=0.9, weight_decay=5e-4,
                       schedule="const")


@pytest.mark.parametrize("mode,onchip", [("nearest", True),
                                         ("stochastic", True),
                                         ("stochastic", False)])
@pytest.mark.parametrize("zero_kw", [
    {},
    {"wire_overlap": True},
    {"wire_overlap": True, "wire_bucket_elems": 300},
    {"wire_overlap": True, "wire_bucket_elems": 1},
], ids=["aligned", "overlap", "overlap_b300", "overlap_b1"])
def test_zero_step_is_the_wire_step_bit_for_bit(mode, onchip, zero_kw):
    """Per-layer wire formats, 8 ranks, 3 steps: the ZeRO step (one bucket
    or several, overlapped or not) and the wire step give the same
    parameters, losses and formats, bit for bit."""
    params, batch = _norm_mlp()
    opt = make_optimizer(SGD_PARITY)
    base = dict(rounding=mode, onchip_prng=onchip, grad_allreduce_bits=8)
    qr = qtrain.QuantConfig(**base).with_per_layer_wire(params)
    qz = qtrain.QuantConfig(**base, zero_opt_shards=8,
                            **zero_kw).with_per_layer_wire(params)
    want = _run_steps(_norm_mlp_loss, params, batch, opt, qr, 8)
    got = _run_steps(_norm_mlp_loss, params, batch, opt, qz, 8)
    step = got[2]
    assert step.zero_opt_active and step.zero_groupaligned_active
    assert step.wire_overlap_active == bool(zero_kw.get("wire_overlap"))
    _assert_same_run(want, got)


@pytest.mark.parametrize("mode", ["nearest", "stochastic"])
@pytest.mark.parametrize("zero", [False, True])
def test_overlap_with_accumulation_is_the_wire_step(mode, zero):
    """Two microbatches a rank: the bucketed wire takes each rank's leaves
    once they are accumulated (no hooks, so the step reports no overlap),
    and still equals the monolithic wire bit for bit."""
    params, batch = _norm_mlp()
    opt = make_optimizer(SGD_PARITY)
    base = dict(rounding=mode, grad_allreduce_bits=8)
    qr = qtrain.QuantConfig(**base).with_per_layer_wire(params)
    qo = qtrain.QuantConfig(**base, wire_overlap=True, wire_bucket_elems=300,
                            zero_opt_shards=8 if zero else None)
    qo = qo.with_per_layer_wire(params)
    want = _run_steps(_norm_mlp_loss, params, batch, opt, qr, 8, accum=2)
    got = _run_steps(_norm_mlp_loss, params, batch, opt, qo, 8, accum=2)
    step = got[2]
    assert not step.wire_overlap_active and step.wire_buckets > 1
    assert step.zero_opt_active == zero
    _assert_same_run(want, got)


@pytest.mark.parametrize("mode", ["nearest", "stochastic"])
def test_zero_overlap_with_one_global_format_is_the_wire_step(mode):
    """One wire format for every leaf: the overlap still runs the aligned
    layout (the format broadcast to every bucket row)."""
    params, batch = _norm_mlp()
    opt = make_optimizer(SGD_PARITY)
    base = dict(rounding=mode, grad_allreduce_bits=8)
    want = _run_steps(_norm_mlp_loss, params, batch, opt,
                      qtrain.QuantConfig(**base), 8)
    got = _run_steps(_norm_mlp_loss, params, batch, opt,
                     qtrain.QuantConfig(**base, zero_opt_shards=8,
                                        wire_overlap=True,
                                        wire_bucket_elems=100), 8)
    assert got[2].zero_groupaligned_active
    _assert_same_run(want, got)


@pytest.mark.parametrize("opt_cfg", [SGD_PARITY, SGDConfig()],
                         ids=["sgd_pow2", "sgd_paper"])
def test_zero_without_the_wire_is_the_replicated_step(opt_cfg):
    """bits=None: the flat-sharded optimizer is a layout change only."""
    params, batch = _norm_mlp()
    opt = make_optimizer(opt_cfg)
    want = _run_steps(_norm_mlp_loss, params, batch, opt,
                      qtrain.QuantConfig(), 8)
    got = _run_steps(_norm_mlp_loss, params, batch, opt,
                     qtrain.QuantConfig(zero_opt_shards=8,
                                        wire_overlap=True), 8)
    step = got[2]
    assert step.zero_opt_active and not step.wire_sync_active
    assert not step.zero_groupaligned_active
    _assert_same_run(want, got)


def test_plain_layout_zero_stays_within_the_wire_grid():
    """One global format without the overlap: the plain layout, whose
    owners mean their chunk without the all-reduce's second snap (the
    reference's semantics), so it is not bit-equal to the wire step; one
    step differs from it by less than a gradient grid step through the
    learning rate."""
    params, batch = _norm_mlp()
    opt = make_optimizer(SGD_PARITY)
    base = dict(rounding="nearest", grad_allreduce_bits=8)
    (sw, hw, _) = _run_steps(_norm_mlp_loss, params, batch, opt,
                             qtrain.QuantConfig(**base), 8, steps=1)
    (sz, hz, step) = _run_steps(_norm_mlp_loss, params, batch, opt,
                                qtrain.QuantConfig(**base, zero_opt_shards=8),
                                8, steps=1)
    assert step.zero_opt_active and not step.zero_groupaligned_active
    assert hz[0]["loss"] == hw[0]["loss"]
    grid = 2.0 ** -hw[0]["fl_wire_grads"]
    for k in params:
        assert float((sz.params[k] - sw.params[k]).abs().max()) \
            <= SGD_PARITY.lr * grid + 2.0 ** -hw[0]["fl_w"], k


def _mlp_loss(params, batch, qctx=None):
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    return torch.mean((h @ params["w2"] - batch["y"]) ** 2), {}


def _mlp_inputs():
    params = {k: torch.from_numpy(MLP_ARRAYS[f"params/{k}"].copy())
              for k in MLP_SHAPES}
    batch = {k: torch.from_numpy(MLP_ARRAYS[k]) for k in ("x", "y")}
    return params, batch


def _mlp_qcfg(params, **kw):
    q = qtrain.QuantConfig(rounding="nearest", grad_allreduce_bits=8,
                           zero_opt_shards=N, **kw)
    return q.with_per_layer_wire(params)


# The fully quantized MLP against the reference's ZeRO step.  Formats of
# every domain are equal step by step.  The two frameworks' fp32 products
# sum in another order, which can move a value across a rounding boundary
# of a grid (then a parameter lands one or two wire_params grid steps
# away).  Measured: loss 1.2e-7 relative, E_wire 2.7e-7, the parameters
# after 3 steps bit-equal (0 of 600 elements differ).
MLP_LOSS_RTOL = 1e-5
MLP_E_WIRE_RTOL = 1e-4
MLP_PARAM_DIFF_FRACTION = 1e-2


def test_fully_quantized_zero_step_matches_the_reference(ref):
    params, batch = _mlp_inputs()
    opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    qcfg = _mlp_qcfg(params)
    tr = StackedTransport(N)
    assert qtrain.wire_params_engaged(qcfg, params, tr)
    state, hist, step = _run_steps(_mlp_loss, params, batch, opt, qcfg, N,
                                   steps=MLP_STEPS)
    assert step.zero_opt_active and step.zero_groupaligned_active
    for k in ("il_w", "fl_w", "il_g", "fl_g", "il_wire_grads",
              "fl_wire_grads", "il_wire_params", "fl_wire_params"):
        np.testing.assert_array_equal([h[k] for h in hist],
                                      ref[f"mlp/hist/{k}"], err_msg=k)
    np.testing.assert_array_equal([h["R_wire"] for h in hist],
                                  ref["mlp/hist/R_wire"])
    np.testing.assert_allclose([h["loss"] for h in hist],
                               ref["mlp/hist/loss"], rtol=MLP_LOSS_RTOL)
    np.testing.assert_allclose([h["E_wire"] for h in hist],
                               ref["mlp/hist/E_wire"], rtol=MLP_E_WIRE_RTOL)
    # the params leg put every parameter on its wire_params grid
    step_p = 2.0 ** -hist[-1]["fl_wire_params"]
    total = differ = 0
    for k in MLP_SHAPES:
        got, want = state.params[k], torch.from_numpy(ref[f"mlp/final/{k}"])
        gap = (got - want).abs()
        assert float(gap.max()) <= 2 * step_p, k
        total, differ = total + got.numel(), differ + int((gap > 0).sum())
    assert differ <= MLP_PARAM_DIFF_FRACTION * total, (differ, total)


def test_zero_opt_state_from_jax_keeps_every_leaf(ref):
    """The reference's flat state, unflattened with its geometry (the jnp
    codec's 128-element quanta) and flattened with the port's: the same
    tree of momenta."""
    params, _ = _mlp_inputs()
    qcfg = _mlp_qcfg(params)
    tr = StackedTransport(N)
    state = zero_opt_state_from_jax({"mu": ref["mlp/opt/mu"]}, params, qcfg,
                                    tr)
    part = qtrain.zero_partitioner(qcfg, params, N)
    assert tuple(state["mu"].shape) == (N, part.shard_size)
    assert part.padded_size != ref["mlp/opt/mu"].size   # other quanta
    tree = part.unflatten(part.assemble(state["mu"]))
    for k in MLP_SHAPES:
        np.testing.assert_array_equal(tree[k].numpy(),
                                      ref[f"mlp/opt_tree/{k}"], err_msg=k)
        assert tree[k].abs().sum() > 0
    with pytest.raises(ValueError, match="layout holds"):
        zero_opt_state_from_jax({"mu": ref["mlp/opt/mu"][:-1]}, params, qcfg,
                                tr)


def test_zero_step_lays_out_the_parameters_once():
    """The first step moves the state's parameters into the flat buffer
    (the leaves become views of it); later steps find them there."""
    params, batch = _mlp_inputs()
    opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    qcfg = _mlp_qcfg(params)
    tr = StackedTransport(N)
    step = qtrain.make_train_step(_mlp_loss, opt, qcfg, transport=tr)
    state = qtrain.TrainState.create(params, qtrain.zero_opt_state(
        opt, params, tr, qcfg), qcfg, 3)
    part = qtrain.zero_partitioner(qcfg, params, N)
    assert part.flat_of(state.params) is None
    state, _ = step(state, batch)
    flat = part.flat_of(state.params)
    assert flat is not None
    state, _ = step(state, batch)
    assert part.flat_of(state.params).data_ptr() == flat.data_ptr()


def test_zero_shard_mismatch_warns_and_falls_back():
    params, batch = _mlp_inputs()
    opt = make_optimizer(SGDConfig())
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, zero_opt_shards=4)
    tr = StackedTransport(2)
    assert not qtrain.zero_opt_engaged(qcfg, tr)
    with pytest.warns(UserWarning, match="does not match"):
        step = qtrain.make_train_step(_mlp_loss, opt, qcfg, transport=tr)
    assert not step.zero_opt_active and step.wire_sync_active
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 3)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    # one rank: nothing to shard, nothing to warn about
    one = qtrain.make_train_step(_mlp_loss, opt, qtrain.QuantConfig(
        zero_opt_shards=1), transport=StackedTransport(1))
    assert not one.zero_opt_active


def test_zero_needs_a_shard_interface_and_guards_still_raise():
    class NoShard:
        cfg = SGDConfig()

        def update(self, *a, **k):
            pass
    with pytest.raises(TypeError, match="update_shard"):
        qtrain.make_train_step(_mlp_loss, NoShard(), qtrain.QuantConfig(
            zero_opt_shards=2), transport=StackedTransport(2))
    # the health guards are armed on ZeRO-1 too: the guarded step builds
    # and runs (tests/test_torch_resilience_zero.py holds it against the
    # reference)
    params, batch = _mlp_inputs()
    opt = make_optimizer(SGDConfig())
    qcfg = qtrain.QuantConfig(zero_opt_shards=2, guards=GuardConfig())
    tr = StackedTransport(2)
    step = qtrain.make_train_step(_mlp_loss, opt, qcfg, transport=tr)
    assert step.zero_opt_active and step.guards_active
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, tr, qcfg), qcfg, 3)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and int(m["health"]) == 0


def test_policy_excluded_leaves_keep_the_params_leg_in_fp32():
    params, _ = _norm_mlp()
    tr = StackedTransport(4)
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, zero_opt_shards=4)
    assert not qtrain.wire_params_engaged(qcfg, params, tr)
    assert "wire_params" in qcfg.plan()
    qm, _ = _mlp_inputs()
    assert qtrain.wire_params_engaged(qcfg, qm, tr)
    assert not qtrain.wire_params_engaged(
        dataclasses.replace(qcfg, zero_opt_shards=None), qm, tr)


@pytest.mark.parametrize("opt_cfg", [
    SGDConfig(clip_norm=0.5), AdamWConfig(warmup=1, total_steps=4)],
    ids=["sgd_clip", "adamw_clip"])
def test_zero_clips_by_the_cross_shard_norm(opt_cfg):
    """With ``clip_norm`` the owners' squares are summed over the axis
    first: the sharded step follows the replicated one to the last bits
    of the norm (another summation order)."""
    params, batch = _norm_mlp()
    opt = make_optimizer(opt_cfg)
    want = _run_steps(_norm_mlp_loss, params, batch, opt,
                      qtrain.QuantConfig(enabled=False), 8)
    got = _run_steps(_norm_mlp_loss, params, batch, opt,
                     qtrain.QuantConfig(enabled=False, zero_opt_shards=8), 8)
    for k in params:
        torch.testing.assert_close(got[0].params[k], want[0].params[k],
                                   rtol=1e-6, atol=1e-6)


def test_update_shard_is_update_segment_by_segment():
    """SGD and AdamW without clipping: the flat shard's step, cut in
    segments, equals the per-leaf step bit for bit."""
    rng = np.random.default_rng(8)
    tree = {"a": torch.from_numpy(rng.standard_normal((6, 5)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(7).astype(
            np.float32))}
    grads = tree_lib.map_tree(lambda v: v * 0.1 + 0.01, tree)
    part = GroupAlignedPartitioner.create(tree, 3, quantum=4,
                                          buckets=((0,), (1,)))
    for cfg in (SGDConfig(), AdamWConfig(clip_norm=0.0)):
        opt = make_optimizer(cfg)
        p_rep = tree_lib.map_tree(torch.clone, tree)
        s_rep = opt.init(p_rep)
        flat, p_sh = part.flat_view(tree)
        s_sh = opt.init_shard((3, part.shard_size))
        gflat = part.flatten(grads)
        for count in range(3):
            opt.update(tree_lib.map_tree(torch.clone, grads), s_rep, p_rep,
                       count)
            for j in range(3):
                g = part.shard(gflat, j)
                for b, (p, (_, so, n)) in enumerate(zip(
                        part.shard_segments(flat, j), part.segments(j))):
                    opt.update_shard(g[so:so + n],
                                     {k: v[j, so:so + n]
                                      for k, v in s_sh.items()},
                                     p, count, rank=j, segment=b)
        for k in tree:
            assert torch.equal(p_rep[k], p_sh[k]), (cfg, k)
    with pytest.raises(ValueError, match="sq_norm"):
        make_optimizer(AdamWConfig()).update_shard(
            torch.zeros(3), {"m": torch.zeros(3), "v": torch.zeros(3)},
            torch.zeros(3), 0)
    assert float(shard_sq_norm([torch.ones(3), 2 * torch.ones(2)])) == 11.0


# ---------------------------------------------------------------------------
# gloo processes against the stacked transport
# ---------------------------------------------------------------------------

# model, QuantConfig fields: the int8 params leg over one bucket and over
# several, the plain packed layout (one global format), the fp32 params leg
# (a policy-excluded leaf), and ZeRO without the wire
GLOO_CASES = {
    "aligned": ("mlp", dict(grad_allreduce_bits=8, per_layer=True)),
    "overlap": ("mlp", dict(grad_allreduce_bits=8, per_layer=True,
                            wire_overlap=True, wire_bucket_elems=100)),
    "plain": ("mlp", dict(grad_allreduce_bits=8)),
    "fp32_params_leg": ("norm_mlp", dict(grad_allreduce_bits=8,
                                         per_layer=True)),
    "no_wire": ("norm_mlp", {}),
}


def _gloo_train(transport, case, mode):
    model, kw = GLOO_CASES[case]
    kw = dict(kw)
    per_layer = kw.pop("per_layer", False)
    if model == "mlp":
        loss_fn, (params, batch) = _mlp_loss, _mlp_inputs()
    else:
        loss_fn, (params, batch) = _norm_mlp_loss, _norm_mlp()
    opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    q = qtrain.QuantConfig(rounding=mode, zero_opt_shards=2, **kw)
    if per_layer:
        q = q.with_per_layer_wire(params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step = qtrain.make_train_step(loss_fn, opt, q, transport=transport)
        assert step.zero_opt_active
        state = qtrain.TrainState.create(
            params, qtrain.zero_opt_state(opt, params, transport, q), q, 3)
        hist = []
        for _ in range(2):
            state, m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items()})
    return ({k: v.clone() for k, v in state.params.items()}, hist,
            state.opt_state["mu"].clone())


def _gloo_rank(rank, world, store_path, out_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {(case, mode): _gloo_train(ProcessGroupTransport(), case, mode)
               for case in GLOO_CASES for mode in ("nearest", "stochastic")}
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_zero_over_gloo_equals_the_stacked_transport(tmp_path):
    world = 2
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, world, str(tmp_path / "store"),
                               str(tmp_path / "out")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    runs = [torch.load(tmp_path / f"out.{r}") for r in range(world)]
    for case in GLOO_CASES:
        for mode in ("nearest", "stochastic"):
            want_p, want_h, want_mu = _gloo_train(StackedTransport(world),
                                                  case, mode)
            for r, run in enumerate(runs):
                got_p, got_h, got_mu = run[(case, mode)]
                for k, v in want_p.items():
                    assert torch.equal(got_p[k], v), (case, mode, k)
                assert got_h == want_h, (case, mode)
                # each process holds its own row of the sharded state
                assert torch.equal(got_mu[0], want_mu[r]), (case, mode)
