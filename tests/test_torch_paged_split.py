"""The split arithmetic of paged decode attention (K5) on the CPU.

The CUDA kernel cuts each row's pages into splits, forms every split's
(m, l, acc) and merges a row's used splits in a fixed order.
``paged_decode_attn_plain(..., split_tokens=n)`` is that arithmetic in plain
PyTorch; here it is held against the JAX package's ``paged_decode_attn_ref``
and against the unsplit page-by-page fold, to 1e-5 max abs in fp32 (the sums
run in another order), across row lengths 0, 1, one split, a split boundary
and one either side, and P·ps; across pages past a row's end that hold
garbage; and across int8 and fp32 pools.  The wrapper's split plan is held
too.  The kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against the same plain version.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attn
from test_torch_jaxref import run_reference

_rng = np.random.default_rng(14)
ATTN_TOL = 1e-5


def _case(B, P, ps, KV, G, Dh, lens, int8, split_tokens):
    """Inputs whose page-table entries past a row's end point at pages that
    no live token uses, filled with the extremes of the pool's range."""
    n_pages = B * P + 1
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
    for b in range(B):
        live = -(-int(lens[b]) // ps)
        dead = ptab[b, live:]
        kp[dead] = 127 if int8 else 1e4
        vp[dead] = -128 if int8 else -1e4
    return {"arrays": {"q": _rng.standard_normal((B, KV * G, Dh)).astype(np.float32),
                       "kp": kp, "vp": vp, "fmt": fmt, "ptab": ptab, "lens": lens},
            "kw": {"scale": float(Dh) ** -0.5},
            "split_tokens": split_tokens}


# splits of two 4-token pages: lengths 0, 1, one split (8), a split boundary
# minus and plus one (7, 9), P·ps (24)
CASES = {
    "int8_edges": _case(6, 6, 4, 2, 3, 16, [0, 1, 8, 7, 9, 24], True, 8),
    "fp32_edges": _case(6, 6, 4, 2, 3, 16, [0, 1, 8, 7, 9, 24], False, 8),
    "int8_ps5": _case(4, 6, 5, 1, 2, 8, [10, 11, 30, 0], True, 12),
    "fp32_odd_dh": _case(3, 5, 4, 2, 2, 6, [20, 3, 13], False, 4),
    "int8_one_page_splits": _case(3, 7, 4, 2, 4, 32, [28, 5, 17], True, 4),
    "int8_all_empty": _case(2, 3, 4, 1, 2, 8, [0, 0], True, 8),
}


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for tag, c in CASES.items():
        jobs.append({"job": "paged_attn", "tag": tag, "kw": c["kw"]})
        arrays.update({f"{tag}/{k}": v for k, v in c["arrays"].items()})
    return run_reference(jobs, arrays)


def _args(a):
    t = lambda v: torch.from_numpy(np.array(v))
    return (t(a["q"]), t(a["kp"]), t(a["vp"]), t(a["fmt"]), t(a["ptab"]),
            t(a["lens"]))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_split_plain_matches_reference_and_unsplit(ref, tag):
    c = CASES[tag]
    args = _args(c["arrays"])
    split = paged_attn.paged_decode_attn_plain(
        *args, scale=c["kw"]["scale"], split_tokens=c["split_tokens"])
    whole = paged_attn.paged_decode_attn_plain(*args, scale=c["kw"]["scale"])
    want = ref[f"{tag}/out"]
    assert split.shape == want.shape and split.dtype == torch.float32
    assert bool(torch.isfinite(split).all())
    assert np.max(np.abs(split.numpy() - want)) <= ATTN_TOL
    assert float((split - whole).abs().max()) <= ATTN_TOL
    # a row of length 0 comes out exactly 0
    empty = c["arrays"]["lens"] == 0
    assert np.all(split.numpy()[empty] == 0.0)
    # without split_tokens the plain version is the page-by-page fold
    assert torch.equal(whole, paged_attn.paged_decode_attn(
        *args, scale=c["kw"]["scale"]))


@pytest.mark.parametrize("tag", ["int8_edges", "fp32_edges", "int8_ps5"])
def test_split_plain_never_reads_past_a_rows_end(tag):
    """Pages past a row's end, and positions past its length in its last
    page, may hold anything: the split arithmetic gives the same bits."""
    c = CASES[tag]
    a = {k: v.copy() for k, v in c["arrays"].items()}
    kw = dict(scale=c["kw"]["scale"], split_tokens=c["split_tokens"])
    before = paged_attn.paged_decode_attn_plain(*_args(a), **kw)
    ps = a["kp"].shape[1]
    int8 = a["kp"].dtype == np.int8
    for b, n in enumerate(a["lens"]):
        for p in range(a["ptab"].shape[1]):
            phys = a["ptab"][b, p]          # every row has pages of its own
            dead = max(0, int(n) - p * ps)
            a["kp"][phys, dead:] = 127 if int8 else np.nan
            a["vp"][phys, dead:] = -128 if int8 else np.inf
    after = paged_attn.paged_decode_attn_plain(*_args(a), **kw)
    assert torch.equal(before, after)


@pytest.mark.parametrize("split_tokens", [4, 8, 12, 16, 24, 100])
def test_split_sizes_agree(split_tokens):
    """Any split size gives the unsplit fold's output to 1e-5, one split
    (of a row of P·ps tokens) included."""
    c = CASES["int8_edges"]
    args = _args(c["arrays"])
    whole = paged_attn.paged_decode_attn_plain(*args, scale=c["kw"]["scale"])
    split = paged_attn.paged_decode_attn_plain(*args, scale=c["kw"]["scale"],
                                               split_tokens=split_tokens)
    assert float((split - whole).abs().max()) <= ATTN_TOL
    assert bool((split[torch.from_numpy(c["arrays"]["lens"] == 0)] == 0).all())


@pytest.mark.parametrize("P,ps,B,KV,G,Dh,esize,tokens,want", [
    # the serving layout: 37 pages of 16 tokens, 128-token splits of int8
    (37, 16, 8, 8, 3, 128, 1, 128, (8, 5, (8, 8, 5, 390))),
    # 8 rows of 4,096 tokens
    (256, 16, 8, 8, 3, 128, 1, 128, (8, 32, (8, 8, 32, 390))),
    # fp32 pools: two stage buffers of K and V cap a split at 48 tokens
    (37, 16, 8, 8, 3, 128, 4, 128, (3, 13, (8, 8, 13, 390))),
    # a split shorter than a page is one page
    (5, 16, 2, 1, 2, 8, 1, 4, (1, 5, (2, 1, 5, 20))),
    # a split longer than the table is one split
    (3, 4, 2, 2, 1, 6, 1, 64, (16, 1, (2, 2, 1, 8))),
    # pages that do not divide the split: whole pages, rounded down
    (9, 5, 4, 2, 5, 20, 1, 12, (2, 5, (4, 2, 5, 110))),
])
def test_split_plan(P, ps, B, KV, G, Dh, esize, tokens, want):
    assert paged_attn.split_plan(P, ps, B, KV, G, Dh, esize, tokens) == want


def test_split_plan_defaults_to_the_wrappers_split():
    """Without a split size the plan is the one the wrapper launches."""
    assert paged_attn.split_plan(37, 16, 8, 8, 3, 128) == paged_attn.split_plan(
        37, 16, 8, 8, 3, 128, 1, paged_attn.SPLIT_TOKENS)


def test_split_plan_rejects_empty_sizes():
    with pytest.raises(ValueError):
        paged_attn.split_plan(0, 16, 8, 8, 3, 128)
    with pytest.raises(ValueError):
        paged_attn.split_plan(37, 16, 8, 8, 3, 128, 1, 0)
