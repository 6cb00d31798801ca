"""The kernels' plain PyTorch versions against the JAX package.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds each against the plain version tested here.  Held:

* grouped wire encode vs ``dps_quant_group_wire_pallas`` (interpret mode)
  and ``dps_quant_group_wire_ref``: wire bytes equal; ``count``,
  ``nonzero``, ``overflow``, ``max_abs`` exact; the float sums to 2e-6
  relative — each side adds thousands of float32 terms per group in its own
  order, and a float32 sum of that length is itself only good to about 1e-6
  (below a few hundred terms the two agree to 1e-6, which
  ``test_torch_fixed_point.py`` holds).  Quanta that are no multiple of 4096 — which
  the TPU kernel refuses — are held against the reference oracle alone.
* paged decode attention vs ``paged_decode_attn_ref``: ≤ 1e-5 max abs in
  fp32 (the reductions run in a different order), a ``lens = 0`` row
  exactly 0.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.fixed_point import FixedPointFormat
from repro_torch.kernels import dps_quant, ops, paged_attn, ref as ref_lib
from test_torch_jaxref import run_reference

_rng = np.random.default_rng(1)
EXACT_COLS, SUM_COLS = (0, 1, 2, 6), (3, 4, 5)
SUM_RTOL = 2e-6


def _encode_case(tiles, quantum, groups, stochastic, pallas):
    n = tiles * quantum
    tg = np.sort(_rng.integers(0, groups, tiles)).astype(np.int32)
    il = _rng.integers(1, 6, groups).astype(np.int32)
    x = (_rng.standard_normal(n) *
         np.repeat(2.0 ** _rng.integers(-4, 4, tiles), quantum)).astype(np.float32)
    x[::13] = 0.0
    return {"arrays": {
        "x": x, "il": il, "fl": (8 - il + _rng.integers(0, 3, groups)
                                 ).astype(np.int32),
        "tile_group": tg,
        "bits": _rng.integers(0, 2**32, n, dtype=np.uint32),
        "mask": (_rng.random(n) > 0.15).astype(np.float32)},
        "kw": {"quantum": quantum, "stochastic": stochastic, "pallas": pallas}}


ENCODE = {
    "enc_4096_nearest": _encode_case(5, 4096, 3, False, True),
    "enc_4096_stoch": _encode_case(4, 4096, 4, True, True),
    "enc_8192_one_group": _encode_case(2, 8192, 1, True, True),
    "enc_1024_nearest": _encode_case(7, 1024, 3, False, False),
    "enc_100_stoch": _encode_case(9, 100, 4, True, False),
    "enc_7_empty_group": _encode_case(6, 7, 9, False, False),
    "enc_1_stoch": _encode_case(11, 1, 2, True, False),
}


def _attn_case(B, P, ps, KV, G, Dh, lens, int8):
    n_pages = B * P + 1
    H = KV * G
    if int8:
        kp = _rng.integers(-128, 128, (n_pages, ps, KV, Dh)).astype(np.int8)
        vp = _rng.integers(-128, 128, (n_pages, ps, KV, Dh)).astype(np.int8)
        fmt = _rng.integers(3, 8, (n_pages, 2)).astype(np.int32)
    else:
        kp = _rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
        vp = _rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
        fmt = np.zeros((n_pages, 2), np.int32)
    lens = np.asarray(lens, np.int32)
    ptab = _rng.permutation(n_pages - 1)[:B * P].reshape(B, P).astype(np.int32)
    for b in range(B):       # entries past a row's last page: the trash page
        ptab[b, -(-int(lens[b]) // ps):] = n_pages - 1
    return {"arrays": {"q": _rng.standard_normal((B, H, Dh)).astype(np.float32),
                       "kp": kp, "vp": vp, "fmt": fmt, "ptab": ptab,
                       "lens": lens},
            "kw": {"scale": float(Dh) ** -0.5}}


ATTN = {
    "attn_int8_mixed": _attn_case(4, 4, 4, 2, 2, 16, [1, 7, 16, 0], True),
    "attn_fp32_mixed": _attn_case(3, 3, 4, 2, 2, 16, [12, 0, 5], False),
    "attn_int8_gqa3": _attn_case(2, 5, 8, 2, 3, 32, [40, 9], True),
    "attn_int8_mha": _attn_case(2, 2, 4, 4, 1, 8, [8, 3], True),
    "attn_all_empty": _attn_case(2, 2, 4, 1, 2, 8, [0, 0], True),
}


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for job, cases in (("group_encode", ENCODE), ("paged_attn", ATTN)):
        for tag, c in cases.items():
            jobs.append({"job": job, "tag": tag, "kw": c["kw"]})
            arrays.update({f"{tag}/{k}": v for k, v in c["arrays"].items()})
    return run_reference(jobs, arrays)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hold_stats(got, want):
    np.testing.assert_array_equal(got[:, EXACT_COLS], want[:, EXACT_COLS])
    np.testing.assert_allclose(got[:, SUM_COLS], want[:, SUM_COLS],
                               rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("tag", sorted(ENCODE))
def test_group_encode_plain_matches_reference(ref, tag):
    c = ENCODE[tag]
    a, kw = c["arrays"], c["kw"]
    fmt_tab = _t(np.stack([a["il"], a["fl"]], axis=1))
    bits = _t(a["bits"]) if kw["stochastic"] else None
    wire, stats = dps_quant.dps_quant_group_wire(
        _t(a["x"]), fmt_tab, _t(a["tile_group"]), bits, _t(a["mask"]),
        quantum=kw["quantum"])
    assert wire.dtype == torch.int8
    np.testing.assert_array_equal(wire.numpy(), ref[f"{tag}/ref_wire"])
    _hold_stats(stats.numpy(), ref[f"{tag}/ref_stats"])
    assert not np.any(wire.numpy()[a["mask"] == 0.0])
    if kw["pallas"]:
        np.testing.assert_array_equal(wire.numpy(), ref[f"{tag}/pallas_wire"])
        np.testing.assert_array_equal(wire.numpy(),
                                      ref[f"{tag}/pallas_wire_nostats"])
        _hold_stats(stats.numpy(), ref[f"{tag}/pallas_stats"])
    # emit_stats=False: the same bytes, no statistics
    w2, s2 = dps_quant.dps_quant_group_wire(
        _t(a["x"]), fmt_tab, _t(a["tile_group"]), bits, _t(a["mask"]),
        quantum=kw["quantum"], emit_stats=False)
    assert s2 is None and torch.equal(wire, w2)


@pytest.mark.parametrize("tag", sorted(ENCODE))
def test_group_encode_ops_and_oracle_agree(tag):
    """``ops.dps_quantize_wire_grouped`` (format object in, QuantStats out)
    and the port's own oracle built on ``wire_quantize`` give the plain
    version's bytes and statistics."""
    c = ENCODE[tag]
    a, kw = c["arrays"], c["kw"]
    fmt = FixedPointFormat(_t(a["il"]), _t(a["fl"]))
    bits = _t(a["bits"]) if kw["stochastic"] else None
    wire, s = ops.dps_quantize_wire_grouped(
        _t(a["x"]), fmt, _t(a["tile_group"]), bits=bits, mask=_t(a["mask"]),
        stochastic=kw["stochastic"], quantum=kw["quantum"])
    w_ref, m_ref = ref_lib.dps_quant_group_wire_ref(
        _t(a["x"]), fmt.il, fmt.fl, _t(a["tile_group"]), bits, _t(a["mask"]),
        kw["quantum"], mode="stochastic" if kw["stochastic"] else "nearest")
    assert torch.equal(wire, w_ref)
    got = torch.stack([s.count, s.nonzero, s.overflow, s.abs_err_sum,
                       s.rel_err_sum, s.abs_sum, s.max_abs], dim=1)
    _hold_stats(got.numpy(), m_ref.numpy())


@pytest.mark.parametrize("tag", sorted(ATTN))
def test_paged_attn_plain_matches_reference(ref, tag):
    c = ATTN[tag]
    a = c["arrays"]
    out = paged_attn.paged_decode_attn(
        _t(a["q"]), _t(a["kp"]), _t(a["vp"]), _t(a["fmt"]), _t(a["ptab"]),
        _t(a["lens"]), scale=c["kw"]["scale"])
    want = ref[f"{tag}/out"]
    assert out.shape == want.shape and out.dtype == torch.float32
    assert np.max(np.abs(out.numpy() - want)) <= 1e-5
    empty = a["lens"] == 0
    assert np.all(out.numpy()[empty] == 0.0)
    assert np.all(np.isfinite(out.numpy()))
    # the port's oracle is the same function
    o2 = ref_lib.paged_decode_attn_ref(
        _t(a["q"]), _t(a["kp"]), _t(a["vp"]), _t(a["fmt"]), _t(a["ptab"]),
        _t(a["lens"]), scale=c["kw"]["scale"])
    assert torch.equal(out, o2)


def test_paged_attn_ignores_trash_page_content():
    """What lies in pages past a row's length never reaches the output."""
    a = {k: v.copy() for k, v in ATTN["attn_int8_mixed"]["arrays"].items()}
    args = lambda: (_t(a["q"]), _t(a["kp"]), _t(a["vp"]), _t(a["fmt"]),
                    _t(a["ptab"]), _t(a["lens"]))
    o1 = paged_attn.paged_decode_attn(*args(), scale=0.25)
    a["kp"][-1] = 127
    a["vp"][-1] = -128
    o2 = paged_attn.paged_decode_attn(*args(), scale=0.25)
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("which", ["encode", "attn"])
def test_kernel_backend_on_a_cpu_tensor_raises(which):
    """A wrapper runs its plain version only because the tensor lies on the
    CPU; asked for the kernel there, it raises."""
    if which == "encode":
        a = ENCODE["enc_100_stoch"]["arrays"]
        with pytest.raises(ValueError, match="CUDA"):
            dps_quant.dps_quant_group_wire(
                _t(a["x"]), _t(np.stack([a["il"], a["fl"]], 1)),
                _t(a["tile_group"]), None, None, quantum=100, backend="kernel")
        assert dps_quant.launch_count == 0
    else:
        a = ATTN["attn_int8_mha"]["arrays"]
        with pytest.raises(ValueError, match="CUDA"):
            paged_attn.paged_decode_attn(
                _t(a["q"]), _t(a["kp"]), _t(a["vp"]), _t(a["fmt"]),
                _t(a["ptab"]), _t(a["lens"]), scale=1.0, backend="kernel")
        assert paged_attn.launch_count == 0


@pytest.mark.parametrize("bad", ["dtype", "quantum", "tile_group", "mask",
                                 "backend"])
def test_group_encode_wrapper_checks_its_arguments(bad):
    x = torch.zeros(12)
    tab = torch.tensor([[2, 6]], dtype=torch.int32)
    tg = torch.zeros(3, dtype=torch.int32)
    kw = dict(quantum=4)
    args = [x, tab, tg, None, None]
    err = TypeError
    if bad == "dtype":
        args[0] = x.to(torch.float64)
    elif bad == "quantum":
        kw["quantum"], err = 5, ValueError
    elif bad == "tile_group":
        args[2] = tg.to(torch.int64)
    elif bad == "mask":
        args[4] = torch.ones(11)
    else:
        kw["backend"], err = "jnp", ValueError
    with pytest.raises(err):
        dps_quant.dps_quant_group_wire(*args, **kw)


@pytest.mark.parametrize("bad", ["q_dtype", "heads", "fmt", "lens"])
def test_paged_attn_wrapper_checks_its_arguments(bad):
    a = {k: _t(v) for k, v in ATTN["attn_int8_mha"]["arrays"].items()}
    err = TypeError
    if bad == "q_dtype":
        a["q"] = a["q"].double()
    elif bad == "heads":
        a["q"], err = a["q"][:, :3].contiguous(), ValueError
    elif bad == "fmt":
        a["fmt"] = a["fmt"][:-1].contiguous()
    else:
        a["lens"] = a["lens"].to(torch.int64)
    with pytest.raises(err):
        paged_attn.paged_decode_attn(a["q"], a["kp"], a["vp"], a["fmt"],
                                     a["ptab"], a["lens"], scale=1.0)
