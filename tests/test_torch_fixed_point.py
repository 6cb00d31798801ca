"""repro_torch.core against repro.core on shared numpy inputs.

Held: int8 wire bytes and grid values bit-equal; ``count``, ``nonzero``,
``overflow``, ``max_abs`` exact; the three float sums to 1e-6 relative (the
two frameworks sum in different orders).  FlexPoint ⟨IL, FL⟩ and ``max_ema``
exactly equal, including at powers of two and their float neighbours.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import dps
from repro_torch.core import fixed_point as fxp
from test_torch_jaxref import STAT_NAMES, run_reference

EXACT = ("count", "nonzero", "overflow", "max_abs")
SUMS = ("abs_err_sum", "rel_err_sum", "abs_sum")

_rng = np.random.default_rng(0)
G = 5


def _case(shape, il, fl, *, wire, mode, mask=False, groups=False):
    x = (_rng.standard_normal(shape) *
         2.0 ** _rng.integers(-4, 5, shape[:1] + (1,) * (len(shape) - 1))
         ).astype(np.float32)
    x.flat[::17] = 0.0
    a = {"x": x, "il": np.asarray(il, np.int32), "fl": np.asarray(fl, np.int32)}
    if mode == "stochastic":
        a["bits"] = _rng.integers(0, 2**32, shape, dtype=np.uint32)
    if mask:
        a["mask"] = (_rng.random(shape) > 0.2).astype(np.float32)
    return {"arrays": a, "kw": {"wire": wire, "mode": mode}}


CASES = {
    "q_nearest": _case((33, 40), 4, 6, wire=False, mode="nearest"),
    "q_stoch": _case((33, 40), 3, 9, wire=False, mode="stochastic"),
    "q_wide": _case((7, 19), 9, 16, wire=False, mode="stochastic"),
    "q_narrow": _case((64,), 2, 1, wire=False, mode="nearest"),
    "w_nearest": _case((33, 40), 3, 5, wire=True, mode="nearest"),
    "w_stoch": _case((33, 40), 2, 6, wire=True, mode="stochastic"),
    "w_overwide": _case((8, 31), 6, 7, wire=True, mode="stochastic"),
    "w_mask": _case((12, 50), 3, 5, wire=True, mode="nearest", mask=True),
    "w_groups": _case((G, 37), [1, 2, 3, 4, 6], [7, 6, 5, 4, 4], wire=True,
                      mode="nearest"),
    "w_groups_stoch_mask": _case((G, 8, 9), [2, 2, 3, 5, 8], [6, 6, 5, 3, 0],
                                 wire=True, mode="stochastic", mask=True),
}

# FlexPoint sequences: random magnitudes, then the edge cases — exact powers
# of two and their float neighbours, zeros, tiny and huge values
_pows = 2.0 ** np.arange(-8, 8, dtype=np.float32)
_edges = np.concatenate([_pows, np.nextafter(_pows, np.float32(0)),
                         np.nextafter(_pows, np.float32(np.inf)),
                         np.array([0.0, 1e-36, 1e-30, 3e4, 1e30], np.float32)])
_GF = _edges.size
_T = 6
_seq = (_rng.standard_normal((_T, _GF)).astype(np.float32) ** 2 *
        2.0 ** _rng.integers(-6, 6, (_T, _GF))).astype(np.float32)
_seq[0] = _edges
_seq[3] = _edges[::-1]
_seq[4] = 0.0
_flex_arrays = {"max_abs": _seq,
                "abs_sum": (_seq * _rng.uniform(1, 9, _seq.shape)
                            ).astype(np.float32),
                "nonzero": _rng.integers(0, 30, _seq.shape).astype(np.float32)}
FLEX = {
    "flex_default": {"hyper": {}, "wire": None},
    "flex_16bit_slack2": {"hyper": {"flex_slack": 2.0, "flex_decay": 0.5,
                                    "il_init": 3}, "wire": None},
    "flex_kv": {"hyper": {}, "wire": {"wire_bits": 8, "il_init": 2,
                                      "slack": 0.0}},
    "flex_wire_neg": {"hyper": {}, "wire": {"wire_bits": 8, "il_init": 4,
                                            "slack": -1.0}},
}
LAYOUT = dict(page_size=4, n_pages=6, batch_slots=2, max_pages_per_seq=5,
              max_prompt=8)


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for tag, c in CASES.items():
        jobs.append({"job": "quantize", "tag": tag, "kw": c["kw"]})
        arrays.update({f"{tag}/{k}": v for k, v in c["arrays"].items()})
    for tag, kw in FLEX.items():
        jobs.append({"job": "flexpoint", "tag": tag, "kw": kw})
        arrays.update({f"{tag}/{k}": v for k, v in _flex_arrays.items()})
    jobs.append({"job": "kv_plan_init", "tag": "kvinit",
                 "kw": {"layout": LAYOUT, "il_init": 2}})
    return run_reference(jobs, arrays)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_quantize_matches_reference(ref, tag):
    c = CASES[tag]
    a = c["arrays"]
    fmt = fxp.FixedPointFormat(_t(a["il"]), _t(a["fl"]))
    kw = dict(mode=c["kw"]["mode"],
              bits=_t(a["bits"]) if "bits" in a else None)
    if c["kw"]["wire"]:
        q, s = fxp.wire_quantize(_t(a["x"]), fmt,
                                 mask=_t(a["mask"]) if "mask" in a else None,
                                 **kw)
        assert q.dtype == torch.int8
    else:
        q, s = fxp.quantize(_t(a["x"]), fmt, **kw)
    np.testing.assert_array_equal(q.numpy(), ref[f"{tag}/q"])
    for n in EXACT:
        np.testing.assert_array_equal(getattr(s, n).numpy(), ref[f"{tag}/{n}"],
                                      err_msg=n)
    for n in SUMS:
        np.testing.assert_allclose(getattr(s, n).numpy(), ref[f"{tag}/{n}"],
                                   rtol=1e-6, atol=0, err_msg=n)


def test_quantize_without_stats_and_int32_bits():
    """``compute_stats=False`` gives the same grid values, and the rounding
    bits may arrive as int32 storage of the same 32 bits."""
    a = CASES["w_stoch"]["arrays"]
    fmt = fxp.FixedPointFormat(_t(a["il"]), _t(a["fl"]))
    w1, s1 = fxp.wire_quantize(_t(a["x"]), fmt, bits=_t(a["bits"]))
    w2, s2 = fxp.wire_quantize(_t(a["x"]), fmt, compute_stats=False,
                               bits=_t(a["bits"].view(np.int32)))
    assert s2 is None and torch.equal(w1, w2)


def test_exp2_int_is_exact():
    n = torch.arange(-126, 128, dtype=torch.int32)
    got = fxp.exp2_int(n).numpy()
    want = np.ldexp(np.float32(1), np.arange(-126, 128)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert fxp.exp2_int(torch.tensor(300)).item() == 2.0 ** 127


def test_stats_merge_and_derived_metrics():
    x = _t(CASES["q_nearest"]["arrays"]["x"])
    fmt = fxp.FixedPointFormat.create(3, 4)
    _, s1 = fxp.quantize(x[:10], fmt, mode="nearest")
    _, s2 = fxp.quantize(x[10:], fmt, mode="nearest")
    _, s = fxp.quantize(x, fmt, mode="nearest")
    m = s1.merge(s2)
    for n in EXACT:
        assert getattr(m, n).item() == getattr(s, n).item(), n
    assert m.overflow_rate().item() == pytest.approx(
        s.overflow.item() / s.count.item())
    assert m.quant_error("ratio").item() == pytest.approx(
        s.quant_error("ratio").item(), rel=1e-5)
    assert fxp.QuantStats.zero((3,)).quant_error().shape == (3,)
    with pytest.raises(ValueError):
        s.quant_error("nope")


# Where the two may differ, and why: IL is the smallest width whose range
# covers the prediction, ceil(log2(pred)) + 1.  The port reads the ceiling
# from the float's bits, exactly.  The reference takes a float32 log2, and
# at the float just above 2^k that logarithm rounds down to k itself once
# k + 2^-23/ln2 is no longer representable (k >= 4; the reference's library
# already does at k = 3), so there it places the radix one bit lower.  Those
# inputs — a predicted max one ulp above 8, 16, 32, ... — are held to
# "reference or one more"; every other input, exactly.
def _just_above_pow2(pred):
    m, e = np.frexp(pred.astype(np.float64))
    return (m == np.nextafter(np.float32(0.5), np.float32(1))) & (e - 1 >= 3)


@pytest.mark.parametrize("tag", sorted(FLEX))
def test_flexpoint_trajectory_matches_reference(ref, tag):
    kw = FLEX[tag]
    h = dps.wire_hyper(**kw["wire"]) if kw["wire"] else dps.DPSHyper(**kw["hyper"])
    ctrl = dps.make_controller("flexpoint", h)
    st = ctrl.init((_GF,))
    z = torch.zeros(_GF)
    soft = np.zeros(_GF, bool)
    n_soft = 0
    for t in range(_T + 1):
        r_il, r_fl = ref[f"{tag}/il"][t], ref[f"{tag}/fl"][t]
        il, fl = st.il.numpy(), st.fl.numpy()
        np.testing.assert_array_equal(il[~soft], r_il[~soft], str(t))
        np.testing.assert_array_equal(fl[~soft], r_fl[~soft], str(t))
        assert np.all((il[soft] == r_il[soft]) | (il[soft] == r_il[soft] + 1))
        np.testing.assert_array_equal(il + fl, r_il + r_fl)
        np.testing.assert_array_equal(st.max_ema.numpy(),
                                      ref[f"{tag}/max_ema"][t], str(t))
        if t == _T:
            break
        stats = fxp.QuantStats(count=z + 1, nonzero=_t(_flex_arrays["nonzero"][t]),
                               overflow=z, abs_err_sum=z, rel_err_sum=z,
                               abs_sum=_t(_flex_arrays["abs_sum"][t]),
                               max_abs=_t(_flex_arrays["max_abs"][t]))
        st = ctrl.update(st, stats)
        soft = _just_above_pow2(st.max_ema.numpy()
                                * np.float32(2.0 ** h.flex_slack))
        n_soft += int(soft.sum())
    assert st.il.dtype == torch.int32 and st.fl.dtype == torch.int32
    assert n_soft < 0.15 * _T * _GF      # the exception stays an exception


def test_ceil_log2_is_exact_at_powers_of_two_and_neighbours():
    want = np.ceil(np.log2(_edges[_edges > 1e-37].astype(np.float64)))
    got = dps._ceil_log2(_t(_edges[_edges > 1e-37])).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_kv_plan_init_rows_match_reference(ref):
    from repro_torch.configs.base import get_config, smoke
    from repro_torch.serve import PagedLayout, cache as kvc
    cfg = smoke(get_config("llama3_2_3b"))
    st = kvc.kv_plan(cfg, PagedLayout(**LAYOUT), 2).init("cpu")[kvc.KV_DOMAIN]
    for n in ("il", "fl", "max_ema"):
        np.testing.assert_array_equal(getattr(st, n).numpy(), ref[f"kvinit/{n}"])


def test_unported_controllers_are_named():
    for name in ("paper", "courbariaux", "na_mukhopadhyay", "static"):
        with pytest.raises(NotImplementedError, match=name):
            dps.make_controller(name)
    with pytest.raises(ValueError):
        dps.make_controller("nope")


def test_precision_plan_routes_and_broadcasts():
    spec = dps.DomainSpec("flexpoint", dps.wire_hyper(8, 2, slack=0.0),
                          groups=4, wire=True)
    plan = dps.PrecisionPlan.of(kv=spec)
    b = plan.init("cpu")
    assert plan.names == ("kv",) and "kv" in plan and len(b) == 1
    one = fxp.QuantStats(*(torch.tensor(v) for v in (1., 1., 0., 0., 0., 3., 3.)))
    b2 = plan.update(b, {"kv": one})                  # scalar stream broadcasts
    assert b2["kv"].il.tolist() == [3, 3, 3, 3]
    assert plan.formats(b2)["kv"].fl.tolist() == [5, 5, 5, 5]
    b3 = plan.update(b2, {})                          # absent stream -> zeros
    assert b3["kv"].max_ema.tolist() == pytest.approx([2.7] * 4)
    with pytest.raises(ValueError):
        plan.update(b, {"kv": fxp.QuantStats.zero((3,))})
    with pytest.raises(ValueError):
        dps.PrecisionPlan((("a", spec), ("a", spec)))
