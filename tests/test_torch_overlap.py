"""The backward-overlapped bucketed wire in the port, against the
reference's and against the port's monolithic wire.

* ``plan_buckets`` gives the reference's runs, run for run (the smoke and
  the full-width llama3.2-3b leaf sizes among them: 11 buckets at full
  width, one per leaf).
* ``bucketed_allreduce_mean_tree`` under nearest rounding on
  ``StackedTransport(4)`` against the reference under ``shard_map`` on 4
  forced CPU devices, scalar and per-leaf formats: means bit-equal,
  count/nonzero/overflow/max_abs exact, float sums to 1e-6 relative; and
  bit-equal to the port's monolithic all-reduce under both rounding modes
  and both bit sources, whatever order the leaves are encoded in.
* The overlapped step (a post-accumulate-grad hook per leaf) equals the
  wire step bit for bit; each leaf is encoded once per rank per step.
* The smoke LM's ZeRO + overlap step against the reference's ZeRO +
  overlap step, 2 ranks, nearest rounding, held to the wire step's
  tolerances (``tests/test_torch_wire_train.py``).
* The launch counts of a ZeRO step, with and without the overlap, that
  ``chip_smoke.py`` holds the card to; the training CLI on the CPU.
"""

import math
import random

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import FixedPointFormat
from repro_torch.core.policy import QuantPolicy
from repro_torch.dist import (BucketPlan, BucketedWire,
                              GroupAlignedPartitioner, StackedTransport,
                              TreeAllReduce, bucketed_allreduce_mean_tree,
                              dps_allreduce_mean_tree, plan_buckets,
                              psum_stats)
from repro_torch.launch import train as train_cli
from repro_torch.models import registry, transformer
from repro_torch.optim import SGDConfig, make_optimizer
from test_torch_jaxref import (STAT_NAMES, one_thread,  # noqa: F401
                               run_reference, unflatten)
from test_torch_wire_train import (CFG, E_COMPUTE_RTOL, E_WIRE_RTOL, FMTS,
                                   LOSS_RTOL, PARAM_DIFF_FRACTION,
                                   PARAM_DIFF_STEPS, _run, _smoke_params)

EXACT = ("count", "nonzero", "overflow", "max_abs")
SUM_RTOL = 1e-6
N = 4


def _leaf_sizes(cfg):
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    return [math.prod(d.shape) for d in tree_lib.leaves(defs)]


FULL = get_config("llama3_2_3b")
PLANS = {
    "smoke_default": {"sizes": _leaf_sizes(CFG), "target": 1 << 16},
    "smoke_10k": {"sizes": _leaf_sizes(CFG), "target": 10000},
    "full_width": {"sizes": _leaf_sizes(FULL), "target": 1 << 16},
    "small_leaves": {"sizes": [3, 5, 7, 1, 300, 2, 2], "target": 8},
    "one_leaf": {"sizes": [37], "target": 1},
    "exact_fill": {"sizes": [4, 4, 4, 4], "target": 8},
}

TREE = {"a": (7, 13), "b": (4097,), "c": {"d": (300, 5), "e": (1,)},
        "f": (2, 3, 40)}
_rng = np.random.default_rng(31)


def _tree_arrays(scale=0.3):
    return {"/".join(p): np.asarray(_rng.standard_normal((N,) + s) * scale,
                                    np.float32)
            for p, s in tree_lib.leaves_with_path(TREE)}


TREE_ARRAYS = _tree_arrays()
G = len(tree_lib.leaves(TREE))
LEAF_FMT = {"il": np.asarray([2, 1, 3, 2, 1], np.int32),
            "fl": np.asarray([6, 7, 5, 6, 7], np.int32)}
SCALAR_FMT = {"il": np.asarray(2, np.int32), "fl": np.asarray(6, np.int32)}
BUCKETED = {f"{f}_{t}": {"kind": "bucketed", "target": t}
            for f in ("scalar", "leaf") for t in (300, 1, 1 << 16)}
ZERO_LM = dict(steps=3, seq=16, batch=2, n=2,
               qkw={"zero_opt_shards": 2, "wire_overlap": True,
                    "wire_bucket_elems": 10000})


def _bucketed_arrays():
    out = {}
    for name in BUCKETED:
        fmt = SCALAR_FMT if name.startswith("scalar") else LEAF_FMT
        out.update({f"{name}/{k}": v for k, v in fmt.items()})
        out.update({f"{name}/tree/{k}": v for k, v in TREE_ARRAYS.items()})
    return out


@pytest.fixture(scope="module")
def ref():
    arrays = {f"bk/{k}": v for k, v in _bucketed_arrays().items()}
    return run_reference(
        [{"job": "plan_buckets", "tag": "plan", "kw": {"cases": PLANS}},
         {"job": "zero_halves", "tag": "bk", "kw": {"cases": BUCKETED,
                                                   "n": N}},
         {"job": "wire_lm_train", "tag": "zlm", "kw": ZERO_LM}],
        arrays, host_devices=N)


def _trees():
    tree = unflatten(TREE_ARRAYS, "")
    return [tree_lib.map_tree(lambda v: torch.from_numpy(v[r].copy()), tree)
            for r in range(N)]


def _fmt(arr):
    return FixedPointFormat(torch.as_tensor(arr["il"], dtype=torch.int32),
                            torch.as_tensor(arr["fl"], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_buckets_matches_the_reference(ref, name):
    c = PLANS[name]
    plan = plan_buckets(c["sizes"], c["target"])
    want = [tuple(int(g) for g in row if g >= 0)
            for row in ref[f"plan/{name}/runs"]]
    assert list(plan.buckets) == want
    assert plan.n_leaves == len(c["sizes"])
    for b, run in enumerate(plan.buckets):
        assert all(plan.bucket_of(g) == b for g in run)
    if name == "full_width":
        # every full-width leaf is past the 65,536-element target: one
        # bucket a leaf, last leaf first
        assert plan.n_buckets == 11 and plan.buckets[0] == (10,)


def test_bucket_plans_are_validated():
    with pytest.raises(ValueError, match="partition"):
        BucketPlan(sizes=(1, 2), buckets=((1,),), target=4)
    with pytest.raises(ValueError, match="contiguous"):
        BucketPlan(sizes=(1, 2, 3), buckets=((0, 2), (1,)), target=4)
    with pytest.raises(ValueError, match="reverse flatten"):
        BucketPlan(sizes=(1, 2), buckets=((0,), (1,)), target=4)
    with pytest.raises(ValueError, match="target_elems"):
        plan_buckets((1, 2), 0)


# ---------------------------------------------------------------------------
# the bucketed all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BUCKETED))
def test_bucketed_allreduce_matches_the_shard_map_reference(ref, name):
    fmt = _fmt(LEAF_FMT if name.startswith("leaf") else SCALAR_FMT)
    tr = StackedTransport(N)
    mean, st = bucketed_allreduce_mean_tree(
        _trees(), fmt, tr, 0, mode="nearest",
        target_elems=BUCKETED[name]["target"])
    got = {"/".join(p): v for p, v in tree_lib.leaves_with_path(mean)}
    for k, v in got.items():
        want = ref[f"bk/{name}/out/{k}"]
        for r in range(N):          # the same mean on every rank
            np.testing.assert_array_equal(v.numpy(), want[r], err_msg=k)
    st = psum_stats(st, tr)
    for k in STAT_NAMES:
        if k in EXACT:
            np.testing.assert_array_equal(getattr(st, k).numpy(),
                                          ref[f"bk/{name}/{k}"], err_msg=k)
        else:
            np.testing.assert_allclose(getattr(st, k).numpy(),
                                       ref[f"bk/{name}/{k}"], rtol=SUM_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("mode,onchip", [("nearest", True),
                                         ("stochastic", True),
                                         ("stochastic", False)])
@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("target", [1, 300, 5000])
def test_bucketed_allreduce_is_the_monolithic_one(mode, onchip, per_leaf,
                                                  target):
    fmt = _fmt(LEAF_FMT if per_leaf else SCALAR_FMT)
    tr = StackedTransport(N)
    want, ws = dps_allreduce_mean_tree(_trees(), fmt, tr, 7, mode=mode,
                                       onchip_prng=onchip)
    got, gs = bucketed_allreduce_mean_tree(_trees(), fmt, tr, 7, mode=mode,
                                           onchip_prng=onchip,
                                           target_elems=target)
    for a, b in zip(tree_lib.leaves(want), tree_lib.leaves(got)):
        assert torch.equal(a, b)
    for a, b in zip(ws, gs):
        for k in STAT_NAMES:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_leaf_is_encoded_once_whatever_order_it_arrives_in(
        monkeypatch, seed):
    """Leaves of every rank handed to the bucketed wire in a shuffled
    order: every leaf of every rank is encoded once, and the mean and
    statistics are those of the flatten order."""
    fmt = _fmt(LEAF_FMT)
    tr = StackedTransport(N)
    trees = _trees()
    runs = sorted(plan_buckets([l.numel() for l in tree_lib.leaves(trees[0])],
                               300).buckets)

    def run(order):
        calls = []
        encode_leaf = TreeAllReduce.encode_leaf

        def counted(self, rank, g, leaf):
            calls.append((rank, self.group_base + g))
            return encode_leaf(self, rank, g, leaf)
        monkeypatch.setattr(TreeAllReduce, "encode_leaf", counted)
        bw = BucketedWire(trees[0], fmt, tr, 5, runs=runs,
                          mode="stochastic")
        for r, g in order:
            bw.encode_leaf(r, g, tree_lib.leaves(trees[r])[g])
        monkeypatch.setattr(TreeAllReduce, "encode_leaf", encode_leaf)
        mean, stats = bw.finish()
        return calls, mean, stats

    flat_order = [(r, g) for r in range(N) for g in range(G)]
    shuffled = list(flat_order)
    random.Random(seed).shuffle(shuffled)
    calls_a, mean_a, st_a = run(flat_order)
    calls_b, mean_b, st_b = run(shuffled)
    assert sorted(calls_b) == sorted(flat_order) == sorted(calls_a)
    for a, b in zip(tree_lib.leaves(mean_a), tree_lib.leaves(mean_b)):
        assert torch.equal(a, b)
    for a, b in zip(st_a, st_b):
        for k in STAT_NAMES:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    bw = BucketedWire(trees[0], fmt, tr, 5, runs=runs)
    bw.encode_leaf(0, 1, tree_lib.leaves(trees[0])[1])
    with pytest.raises(RuntimeError, match="twice"):
        bw.encode_leaf(0, 1, tree_lib.leaves(trees[0])[1])
    with pytest.raises(RuntimeError, match="encode every leaf"):
        bw.rank_stats(0)


# ---------------------------------------------------------------------------
# the overlapped step
# ---------------------------------------------------------------------------

def _lm_step(n, **qkw):
    params = _smoke_params()
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, **qkw)
    qcfg = qcfg.with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig())
    tr = StackedTransport(n)
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=tr)
    opt_state = (qtrain.zero_opt_state(opt, params, tr, qcfg)
                 if step.zero_opt_active else opt.init(params))
    return step, qtrain.TrainState.create(params, opt_state, qcfg, 3)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("zero", [False, True])
def test_overlapped_lm_step_is_the_wire_step(monkeypatch, one_thread,
                                             rounding, zero):
    """The smoke LM, 2 ranks, 2 steps: the overlapped step (hooks, 9
    buckets; with ZeRO or without) gives the wire step's parameters and
    formats bit for bit, and encodes every leaf of every rank once a
    step."""
    step_w, state_w = _lm_step(2, rounding=rounding)
    state_w, hist_w = _run(step_w, state_w, 2, 8, 4, FMTS + ("loss",))
    kw = dict(rounding=rounding, wire_overlap=True, wire_bucket_elems=10000)
    if zero:
        kw["zero_opt_shards"] = 2
    calls = []
    encode_leaf = BucketedWire.encode_leaf

    def counted(self, rank, g, leaf):
        calls.append((rank, g))
        return encode_leaf(self, rank, g, leaf)
    monkeypatch.setattr(BucketedWire, "encode_leaf", counted)
    step_o, state_o = _lm_step(2, **kw)
    assert step_o.wire_overlap_active and step_o.zero_opt_active == zero
    state_o, hist_o = _run(step_o, state_o, 2, 8, 4, FMTS + ("loss",))
    assert step_o.wire_buckets == 9
    n_leaves = len(tree_lib.leaves(state_o.params))
    assert sorted(calls) == sorted([(r, g) for r in range(2)
                                    for g in range(n_leaves)] * 2)
    # the hooks fire in backward order: the last leaves first
    assert calls[0][1] != 0 and calls[n_leaves - 1][1] == 0
    assert hist_o == hist_w
    for a, b in zip(tree_lib.leaves(state_w.params),
                    tree_lib.leaves(state_o.params)):
        assert torch.equal(a, b)


def test_zero_overlap_lm_steps_match_the_shard_map_reference(ref):
    """2 ranks, nearest rounding, per-layer wire formats, ZeRO-1 with the
    overlapped wire in both packages (9 buckets), from the reference's
    parameters: the wire step's tolerances."""
    params = params_from_jax(unflatten(ref, "zlm/params/"), CFG, "cpu",
                             training=True)
    qcfg = qtrain.QuantConfig(rounding="nearest", grad_allreduce_bits=8,
                              **ZERO_LM["qkw"]).with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig())
    tr = StackedTransport(ZERO_LM["n"])
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=tr)
    assert step.zero_opt_active and step.wire_overlap_active
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, tr, qcfg), qcfg, 1)
    with pytest.warns(UserWarning, match="fp32"):
        state, hist = _run(step, state, ZERO_LM["steps"], ZERO_LM["seq"],
                           ZERO_LM["batch"],
                           FMTS + ("loss", "E_wire", "R_wire", "E_g", "E_a"))
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k]),
                                      ref[f"zlm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref["zlm/hist/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist["E_wire"], ref["zlm/hist/E_wire"],
                               rtol=E_WIRE_RTOL)
    np.testing.assert_array_equal(hist["R_wire"], ref["zlm/hist/R_wire"])
    for k in ("E_g", "E_a"):
        np.testing.assert_allclose(hist[k], ref[f"zlm/hist/{k}"],
                                   rtol=E_COMPUTE_RTOL, err_msg=k)
    assert len(set(hist["il_wire_grads"])) > 1
    final = params_from_jax(unflatten(ref, "zlm/final/"), CFG, "cpu",
                            training=True)
    step_w = 2.0 ** -hist["fl_w"][-1]
    total = differ = 0
    for (path, got), (_, want) in zip(tree_lib.leaves_with_path(state.params),
                                      tree_lib.leaves_with_path(final)):
        gap = (got - want).abs()
        assert float(gap.max()) <= PARAM_DIFF_STEPS * step_w, path
        total, differ = total + got.numel(), differ + int((gap > 0).sum())
    assert differ <= PARAM_DIFF_FRACTION * total, (differ, total)


# ---------------------------------------------------------------------------
# launches, and the CLI
# ---------------------------------------------------------------------------

def _count_kernels(monkeypatch):
    """Count every kernel call where its plain version runs."""
    from repro_torch.kernels import dps_quant as dq
    counts = dict.fromkeys(("K1", "K1b", "K2", "K2b", "K3", "K3b", "K4"), 0)
    quant_call = dq._quant_call

    def counted_quant_call(x, il, fl, bits, compute_stats, out, backend, wire):
        prng = isinstance(bits, dq.Philox)
        counts[("K2" if wire else "K1") + ("b" if prng else "")] += 1
        return quant_call(x, il, fl, bits, compute_stats, out, backend, wire)

    group_plain, reduce_plain = (dq.dps_quant_group_wire_plain,
                                 dq.dps_wire_reduce_plain)

    def counted_group(x, tab, tg, bits=None, *a, **k):
        counts["K3b" if isinstance(bits, dq.GroupPhilox) else "K3"] += 1
        return group_plain(x, tab, tg, bits, *a, **k)

    def counted_reduce(*a, **k):
        counts["K4"] += 1
        return reduce_plain(*a, **k)

    monkeypatch.setattr(dq, "_quant_call", counted_quant_call)
    monkeypatch.setattr(dq, "dps_quant_group_wire_plain", counted_group)
    monkeypatch.setattr(dq, "dps_wire_reduce_plain", counted_reduce)
    return counts


def zero_step_launches(cfg, n, buckets):
    """Launches a ZeRO step of the smoke or full-width LM takes on the card
    (per-layer wire formats, stochastic rounding on the in-kernel Philox),
    with G leaves of which Q quantized, L layers, n ranks and B buckets:
    K1b 2Q + n(2L + Q) (the weights and their re-snap once; each rank's
    taps forward and backward and its raw-gradient statistics; the norm
    scales keep the params leg in fp32, so no optimizer-input snap), K2b
    n·G (leg 1), K4 and K3b n·B (each owner's chunk of each bucket)."""
    pred = QuantPolicy().param_predicate()
    paths = tree_lib.leaves_with_path(transformer.model_defs(cfg))
    G, Q, L = len(paths), sum(pred(p, d) for p, d in paths), cfg.n_layers
    return {"K1": 0, "K1b": 2 * Q + n * (2 * L + Q), "K2": 0, "K2b": n * G,
            "K3": 0, "K3b": n * buckets, "K4": n * buckets}


@pytest.mark.parametrize("overlap", [False, True])
def test_zero_step_launch_counts_rehearse_the_card(monkeypatch, overlap):
    """One ZeRO step of the smoke LM on 4 stacked ranks, every kernel call
    counted where its plain version runs; the full-width counts follow
    from the same rule with 11 buckets (``chip_smoke.py``'s zero phase:
    per step 4 x 11 K2b, 4 x 11 K4 and K3b with the overlap, 4 without)."""
    counts = _count_kernels(monkeypatch)
    kw = dict(zero_opt_shards=4)
    if overlap:
        kw.update(wire_overlap=True, wire_bucket_elems=10000)
    step, state = _lm_step(4, **kw)
    _run(step, state, 1, 8, 4, ("loss",))
    buckets = 9 if overlap else 1
    assert step.wire_buckets == buckets
    assert counts == zero_step_launches(CFG, 4, buckets)
    full = plan_buckets(_leaf_sizes(FULL)).n_buckets
    want = zero_step_launches(FULL, 4, full)
    assert (want["K2b"], want["K4"], want["K3b"]) == (44, 44, 44)


def test_full_width_zero_layout_fits_64_bit_offsets():
    """The full-width overlapped layout, from the shapes alone: 11 buckets,
    one leaf each; the w_in bucket's owner
    chunk is the [4, 176,160,768] K4 reads; the flat buffer passes 2^31
    elements, so every offset into it is a Python int (64-bit in the
    kernels)."""
    defs = transformer.model_defs(FULL, FULL.master_dtype())
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, zero_opt_shards=4,
                              wire_overlap=True).with_per_layer_wire(defs)
    part = qtrain.zero_partitioner(qcfg, defs, 4)
    assert isinstance(part, GroupAlignedPartitioner)
    assert part.n_buckets == 11
    # 4,096-element quanta but for final_norm's 3,072 (one tile)
    assert [lay.quantum for lay in part.layouts] == [
        min(4096, 16 * -(-s // 16)) for s in _leaf_sizes(FULL)]
    paths = [p for p, _ in tree_lib.leaves_with_path(defs)]
    w_in = paths.index(("layers", "mlp", "w_in"))
    assert part.layouts[w_in].chunk == 176_160_768
    assert part.padded_size > 2**31 and part.size == 3_213_536_256
    assert part.leaf_offset(len(paths) - 1) > 2**31


@pytest.mark.parametrize("wire", [True, False])
def test_train_cli_zero_overlap_smoke_on_the_cpu(capsys, wire):
    argv = ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "4", "--seq", "8", "--log-every", "1",
            "--optimizer", "sgd", "--data-ranks", "2", "--zero-opt",
            "--wire-overlap", "on"]
    if wire:
        argv += ["--grad-allreduce-bits", "8"]
    with pytest.warns(UserWarning) if wire else _no_warning():
        out = train_cli.main(argv)
    text = capsys.readouterr().out
    assert out["zero_opt"] and out["data_ranks"] == 2
    assert out["wire_overlap"] == wire and out["wire_sync"] == wire
    assert out["zero_groupaligned"] == wire
    assert out["wire_buckets"] == (2 if wire else 0)
    hist = out["history"]
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    if wire:
        assert text.count("E_wire") >= 3
        assert len({h["il_wire_grads"] for h in hist}) > 1
    # on the CPU the plain versions run: no kernel launch is counted
    assert all(set(n.values()) == {0} for n in out["launches_per_step"])


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
