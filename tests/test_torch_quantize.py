"""The training quantizer (K1 / K1b) of the port against the JAX package.

``dps_quant_plain`` — the CUDA kernel's plain version, which the wrapper runs
for a CPU tensor — and the any-rank ``ops.dps_quantize`` against
``repro.kernels.ops.dps_quantize`` (the Pallas kernel in interpret mode) on
shared bits, after the sweep of the reference's own ``tests/test_kernels.py``.
Held: q bit-equal; count, nonzero, overflow, max_abs exact; the three float
sums to 1e-6 relative up to a few hundred terms and 2e-6 beyond (another
summation order; a float32 sum that long is itself good to ~1e-6).

Also: the Philox4x32-10 stream of K1b against the Random123 known-answer
vectors, the wrapper's switches and argument checks, and ``quantize_tree``
under the default policy against the reference's.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import fixed_point as fxp
from repro_torch.core import tree as tree_lib
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import dps_quant, ops
from repro_torch.kernels import ref as ref_lib
from test_torch_jaxref import STAT_NAMES, run_reference, unflatten

EXACT = ("count", "nonzero", "overflow", "max_abs")

_rng = np.random.default_rng(12)


def _case(shape, il, fl, stochastic=True, bf16=False):
    x = (_rng.standard_normal(shape) * 2.0 ** (il - 2)).astype(np.float32)
    x.flat[::13] = 0.0
    if bf16:       # values a bf16 holds exactly, so both sides see the same x
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    arrays = {"x": x}
    if stochastic:
        arrays["bits"] = _rng.integers(0, 2**32, x.size, dtype=np.uint32)
    return {"arrays": arrays,
            "kw": {"il": il, "fl": fl, "stochastic": stochastic, "bf16": bf16}}


CASES = {
    "s8x128": _case((8, 128), 4, 2),
    "s300x1100": _case((300, 1100), 6, 10),
    "s1x7": _case((1, 7), 4, 2),
    "s513x129": _case((513, 129), 2, 14),
    "n256x1024": _case((256, 1024), 8, 8, stochastic=False),
    "n_wide": _case((37, 41), 16, 9, stochastic=False),
    "bf16": _case((64, 256), 5, 6, bf16=True),
    "rank3": _case((3, 5, 7), 5, 7),
    "pad1500": _case((1500,), 4, 2, stochastic=False),
}


@pytest.fixture(scope="module")
def ref():
    arrays = {f"ops/{name}/{k}": v for name, c in CASES.items()
              for k, v in c["arrays"].items()}
    jobs = [{"job": "quant_ops", "tag": "ops",
             "kw": {"cases": {n: c["kw"] for n, c in CASES.items()}}},
            {"job": "quantize_tree", "tag": "tree",
             "kw": {"seed": 0, "il": 4, "fl": 6}}]
    return run_reference(jobs, arrays)


def _inputs(name):
    c = CASES[name]
    x = torch.from_numpy(c["arrays"]["x"])
    if c["kw"]["bf16"]:
        x = x.to(torch.bfloat16)
    bits = None
    if c["kw"]["stochastic"]:
        bits = torch.from_numpy(c["arrays"]["bits"].view(np.int32))
    return x, bits, c["kw"]


def _hold(got_q, got_stats, ref, name):
    """q bit-equal, integer statistics exact, float sums to tolerance."""
    np.testing.assert_array_equal(got_q.to(torch.float32).numpy(),
                                  ref[f"ops/{name}/q"])
    rtol = 1e-6 if got_q.numel() <= 512 else 2e-6
    for k in STAT_NAMES:
        want = ref[f"ops/{name}/{k}"]
        got = float(getattr(got_stats, k))
        if k in EXACT:
            assert got == float(want), (name, k, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_quantizer_matches_the_pallas_kernel(ref, name):
    """The kernel's plain version on the flat tensor the kernel walks."""
    x, bits, kw = _inputs(name)
    q, vec = dps_quant.dps_quant_plain(
        x.reshape(-1), torch.tensor(kw["il"], dtype=torch.int32),
        torch.tensor(kw["fl"], dtype=torch.int32), bits)
    assert q.dtype == x.dtype
    _hold(q.reshape(x.shape), ref_lib.stats_from_vector(vec), ref, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_any_rank_wrapper_matches_the_reference_wrapper(ref, name):
    x, bits, kw = _inputs(name)
    fmt = fxp.FixedPointFormat.create(kw["il"], kw["fl"])
    q, s = ops.dps_quantize(x, fmt, bits)
    assert q.shape == x.shape and q.dtype == x.dtype
    _hold(q, s, ref, name)


# ---------------------------------------------------------------------------
# Philox4x32-10, the stream of K1b
# ---------------------------------------------------------------------------

KAT = [  # Random123's kat_vectors for philox4x32_10: (ctr, key, out)
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_matches_the_known_answer_vectors(ctr, key, want):
    out = dps_quant.philox4x32_10(torch.tensor([ctr], dtype=torch.int64), key)
    assert [int(v) for v in out[0]] == list(want)


def test_philox_bits_layout_and_chunking():
    """Element e takes word e % 4 of counter e // 4 under key (seed lo, hi);
    the chunk size used to bound temporaries changes nothing."""
    bits = dps_quant.philox_bits(0, 6)
    assert bits.dtype == torch.int32 and bits.shape == (6,)
    words = bits.numpy().view(np.uint32)
    assert list(words[:4]) == list(KAT[0][2])
    seed = 0x0123456789ABCDEF
    want = dps_quant.philox4x32_10(
        torch.tensor([[1, 0, 0, 0]], dtype=torch.int64),
        (seed & 0xFFFFFFFF, seed >> 32))[0]
    got = dps_quant.philox_bits(seed, 9).numpy().view(np.uint32)
    assert list(got[4:8]) == [int(v) for v in want]
    np.testing.assert_array_equal(dps_quant.philox_bits(seed, 1001, chunk=7),
                                  dps_quant.philox_bits(seed, 1001))
    with pytest.raises(ValueError):
        dps_quant.philox_bits(-1, 4)


def test_onchip_prng_on_cpu_is_the_bits_path_fed_philox_words():
    x = torch.from_numpy(_rng.standard_normal(1003).astype(np.float32))
    il, fl = torch.tensor(3, dtype=torch.int32), torch.tensor(9, dtype=torch.int32)
    a, sa = dps_quant.dps_quant(x, il, fl, dps_quant.Philox(77))
    b, sb = dps_quant.dps_quant(x, il, fl, dps_quant.philox_bits(77, 1003))
    assert torch.equal(a, b) and torch.equal(sa, sb)
    c, _ = dps_quant.dps_quant(x, il, fl, dps_quant.Philox(78))
    assert not torch.equal(a, c)


def test_stochastic_rounding_is_unbiased_over_seeds():
    x = torch.from_numpy(_rng.uniform(-1, 1, 4096).astype(np.float32))
    fmt = fxp.FixedPointFormat.create(2, 4)
    acc = torch.zeros_like(x, dtype=torch.float64)
    for s in range(64):
        q, _ = ops.dps_quantize(x, fmt, dps_quant.Philox(s),
                                compute_stats=False)
        acc += q.to(torch.float64)
    y = x.to(torch.float64) * 16
    p = y - torch.floor(y)
    sigma = float(torch.sqrt((p * (1 - p)).sum() / 64)) / 16
    assert abs(float((acc / 64 - x.to(torch.float64)).sum())) < 4 * sigma


def test_wrapper_switches_and_checks():
    x = torch.ones(10)
    il, fl = torch.tensor(4, dtype=torch.int32), torch.tensor(2, dtype=torch.int32)
    bits = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError, match="Philox"):
        dps_quant.dps_quant(x, il, fl, 5)
    with pytest.raises(ValueError, match="64-bit"):
        dps_quant.Philox(1 << 64)
    with pytest.raises(ValueError, match="CUDA"):
        dps_quant.dps_quant(x, il, fl, bits, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        dps_quant.dps_quant(x, il, fl, bits, backend="nope")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dps_quant.dps_quant(x.to(torch.float64), il, fl, bits)
    with pytest.raises(TypeError, match="bits"):
        dps_quant.dps_quant(x, il, fl, bits[:5])
    with pytest.raises(TypeError, match="il"):
        dps_quant.dps_quant(x, il.to(torch.int64), fl, bits)
    # no bits: nearest; compute_stats=False returns none; out= in place
    q, s = dps_quant.dps_quant(x * 0.3, il, fl, compute_stats=False)
    assert s is None and torch.equal(q, torch.full((10,), 0.25))
    y = x * 0.3
    q, _ = dps_quant.dps_quant(y, il, fl, out=y)
    assert q is y and torch.equal(y, torch.full((10,), 0.25))
    # the wrapper takes one global format only
    with pytest.raises(ValueError, match="one global format"):
        ops.dps_quantize(x, fxp.FixedPointFormat.create([1, 2], [3, 4]))


def test_k1_draws_its_bits_from_the_seed():
    """An event's bits: none under nearest rounding, the Philox stream of
    the seed on the chip's generator, else K1's operand drawn from a
    generator seeded with the seed."""
    x = torch.from_numpy(_rng.standard_normal(500).astype(np.float32))
    assert ops.event_bits(x, "nearest", 5, False) is None
    assert ops.event_bits(x, "stochastic", 5, True) == dps_quant.Philox(5)
    a = ops.event_bits(x, "stochastic", 5, False)
    assert a.dtype == torch.int32 and a.numel() == x.numel()
    assert torch.equal(a, ops.event_bits(x, "stochastic", 5, False))
    assert not torch.equal(a, ops.event_bits(x, "stochastic", 6, False))
    with pytest.raises(ValueError, match="rounding mode"):
        ops.event_bits(x, "truncate", 5, False)


# ---------------------------------------------------------------------------
# quantize_tree
# ---------------------------------------------------------------------------

CFG = smoke(get_config("llama3_2_3b"))


def test_quantize_tree_matches_reference_under_the_default_policy(ref):
    params = params_from_jax(unflatten(ref, "tree/params/"), CFG, "cpu")
    qref = unflatten(ref, "tree/q/")
    q, s = fxp.quantize_tree(params, fxp.FixedPointFormat.create(4, 6),
                             mode="nearest",
                             predicate=QuantPolicy().param_predicate())
    pred = QuantPolicy().param_predicate()
    touched = 0
    for (path, leaf), (_, orig) in zip(tree_lib.leaves_with_path(q),
                                       tree_lib.leaves_with_path(params)):
        want = qref
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=str(path))
        if pred(path, orig):
            touched += 1
        else:                     # norms: the very same tensor, untouched
            assert leaf is orig and "norm" in "/".join(path)
    assert touched == 8           # embed + 7 matrices of the layer stack
    for k in STAT_NAMES:
        want, got = float(ref[f"tree/stats/{k}"]), float(getattr(s, k))
        if k in EXACT:
            assert got == want, k
        else:
            np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=k)


def test_quantize_tree_seeds_leaves_by_index_and_bounds_bits_by_layer():
    """Leaf i rounds with fold_seed(seed, i); with a bits operand a stacked
    leaf is drawn layer by layer (seed fold_seed(leaf seed, layer)); in place
    writes over the leaves themselves."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(6, 32, 1 << 15, generator=g),     # > 2^22, 6 layers
            "b": {"c": torch.randn(7, 9, generator=g)},
            "norm": torch.randn(5, generator=g)}
    fmt = fxp.FixedPointFormat.create(3, 6)
    pred = QuantPolicy().param_predicate()
    q, s = fxp.quantize_tree(tree, fmt, seed=11, predicate=pred)
    a_seed = fxp.fold_seed(11, 0)
    def bits(x, seed):
        return ops.event_bits(x, "stochastic", seed, False)

    for layer in (0, 5):
        x = tree["a"][layer]
        want, _ = ops.dps_quantize(x, fmt, bits(x, fxp.fold_seed(a_seed, layer)))
        assert torch.equal(q["a"][layer], want)
    x = tree["b"]["c"]
    want, _ = ops.dps_quantize(x, fmt, bits(x, fxp.fold_seed(11, 1)))
    assert torch.equal(q["b"]["c"], want)
    assert q["norm"] is tree["norm"]
    assert float(s.count) == tree["a"].numel() + 63
    # on-chip generator: one event per leaf, seed fold_seed(seed, i)
    q2, _ = fxp.quantize_tree(tree, fmt, seed=11, predicate=pred,
                              onchip_prng=True)
    want, _ = ops.dps_quantize(tree["a"], fmt, dps_quant.Philox(a_seed))
    assert torch.equal(q2["a"], want)
    # in place
    leaf = tree["b"]["c"]
    q3, _ = fxp.quantize_tree(tree, fmt, mode="nearest", predicate=pred,
                              inplace=True)
    assert q3["b"]["c"] is leaf
    assert torch.equal(leaf, torch.floor(leaf * 64 + 0.5) / 64)


def test_fold_seed_is_a_pure_64_bit_function():
    a = fxp.fold_seed(1, 2, "c")
    assert a == fxp.fold_seed(1, 2, "c") and 0 <= a < 1 << 64
    assert len({fxp.fold_seed(1, i) for i in range(1000)}) == 1000
    assert fxp.fold_seed(1, 2) != fxp.fold_seed(2, 1)
