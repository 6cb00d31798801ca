"""repro_torch.serve.cache against repro.serve.cache on shared prefill caches.

Held: after the same sequence of ``write_prompt_pages`` calls the page pools
are byte-equal — **excluding the trash page**, whose content after a scatter
with duplicate indices is unspecified in both frameworks — and the
controller state (⟨IL, FL⟩ rows and ``max_ema``) is exactly equal; likewise
``fmt_tables`` and ``reset_rows``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.serve import PagedLayout, cache as kvc, page_rows
from test_torch_jaxref import run_reference

CFG = smoke(get_config("llama3_2_3b"))
LAYOUT = dict(page_size=4, n_pages=10, batch_slots=2, max_pages_per_seq=6,
              max_prompt=16)
LAY = PagedLayout(**LAYOUT)
TRASH = LAY.trash_page
RESET_PAGES = [7, 0]

_rng = np.random.default_rng(2)


def _prefill_cache():
    shp = (CFG.n_layers, 1, LAY.max_prompt, CFG.n_kv_heads, CFG.head_dim)
    scale = 2.0 ** _rng.integers(-3, 3, (CFG.n_layers, 1, LAY.prompt_pages, 1, 1))
    scale = np.repeat(scale, LAY.page_size, axis=2)
    return (_rng.standard_normal(shp) * scale).astype(np.float32)


# (prompt length, physical pages of the prompt's page slots): a prompt that
# leaves a generation-region page inside the prompt window, then one whose
# unused slots all point at the trash page (duplicate indices), then a full
# prompt over reused pages
WRITES = [(9, [3, 7, 1, 5]), (5, [0, 2, TRASH, TRASH]), (16, [9, 8, 6, 4])]
ARRAYS = {}
for _i, (_plen, _phys) in enumerate(WRITES):
    ARRAYS[f"ck{_i}"], ARRAYS[f"cv{_i}"] = _prefill_cache(), _prefill_cache()
    ARRAYS[f"phys{_i}"] = np.asarray(_phys, np.int32)
    ARRAYS[f"plen{_i}"] = np.int32(_plen)


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for tag, bits in (("int8", 8), ("fp32", None)):
        jobs.append({"job": "write_pages", "tag": tag, "kw": {
            "layout": LAYOUT, "bits": bits, "n_writes": len(WRITES),
            "reset_pages": RESET_PAGES}})
        arrays.update({f"{tag}/{k}": v for k, v in ARRAYS.items()})
    return run_reference(jobs, arrays)


def _port(bits):
    plan = kvc.kv_plan(CFG, LAY) if bits == 8 else None
    pools = kvc.init_pool(CFG, LAY, bits, "cpu")
    state = plan.init("cpu")[kvc.KV_DOMAIN] if bits == 8 else None
    for i, (plen, _) in enumerate(WRITES):
        pools, state = kvc.write_prompt_pages(
            CFG, LAY, plan, pools, state, torch.from_numpy(ARRAYS[f"ck{i}"]),
            torch.from_numpy(ARRAYS[f"cv{i}"]),
            torch.from_numpy(ARRAYS[f"phys{i}"]), plen, bits=bits,
            encode_backend="auto")
    return plan, pools, state


@pytest.mark.parametrize("tag,bits", [("int8", 8), ("fp32", None)])
def test_write_prompt_pages_pools_match_reference(ref, tag, bits):
    _, pools, _ = _port(bits)
    assert pools.k_pages.dtype == (torch.int8 if bits == 8 else torch.float32)
    for name in ("k_pages", "v_pages"):
        got = getattr(pools, name).numpy()
        want = ref[f"{tag}/{name}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got[:, :TRASH], want[:, :TRASH])
    assert np.any(pools.k_pages.numpy()[:, :TRASH] != 0)


def test_write_prompt_pages_state_matches_reference(ref):
    _, _, state = _port(8)
    for n in ("il", "fl", "max_ema"):
        np.testing.assert_array_equal(getattr(state, n).numpy(),
                                      ref[f"int8/{n}"], err_msg=n)
    # pages hold different content, so they land on different grids
    assert len(set(state.il.tolist())) > 1
    # the generation-region page 5 of the first write kept its init rows
    rows = page_rows(CFG.n_layers, LAY.n_pages_total, [5]).reshape(-1)
    assert set(state.il[rows].tolist()) == {kvc.DEFAULT_IL_INIT}


def test_fp32_write_passes_state_through():
    _, _, state = _port(None)
    assert state is None


def test_fmt_tables_match_reference(ref):
    _, _, state = _port(8)
    k_fmt, v_fmt = kvc.fmt_tables(state, CFG, LAY)
    assert k_fmt.dtype == torch.int32
    np.testing.assert_array_equal(k_fmt.numpy(), ref["int8/k_fmt"])
    np.testing.assert_array_equal(v_fmt.numpy(), ref["int8/v_fmt"])
    zk, zv = kvc.zero_fmt_tables(CFG, LAY, "cpu")
    assert zk.shape == k_fmt.shape and not zk.any() and not zv.any()


def test_reset_rows_matches_reference(ref):
    plan, _, state = _port(8)
    mask = np.zeros(kvc.n_rows(CFG, LAY), bool)
    mask[page_rows(CFG.n_layers, LAY.n_pages_total, RESET_PAGES).reshape(-1)] = True
    st2 = kvc.reset_rows(plan, state, torch.from_numpy(mask))
    for n in ("il", "fl", "max_ema"):
        np.testing.assert_array_equal(getattr(st2, n).numpy(),
                                      ref[f"int8/reset_{n}"], err_msg=n)
    assert set(st2.il[torch.from_numpy(mask)].tolist()) == {kvc.DEFAULT_IL_INIT}


def test_encode_pages_backends():
    """On the CPU ``auto`` is the plain codec; ``kernel`` raises there; a
    page of any size encodes (no 4096-element rule)."""
    E = 24
    x = torch.from_numpy(_rng.uniform(-1.9, 1.9, (3, E)).astype(np.float32))
    fmt = kvc.FixedPointFormat(torch.tensor([2, 2, 3], dtype=torch.int32),
                               torch.tensor([6, 6, 5], dtype=torch.int32))
    ones = torch.ones(3, E)
    w = kvc.encode_pages(x, fmt, ones, backend="auto", quantum=E)
    assert torch.equal(w, kvc.encode_pages(x, fmt, ones, backend="plain",
                                           quantum=E))
    back = w[:2].float() * 2.0 ** -6
    assert (back - x[:2]).abs().max() <= 2.0 ** -7 + 1e-7
    with pytest.raises(ValueError, match="CUDA"):
        kvc.encode_pages(x, fmt, ones, backend="kernel", quantum=E)
    with pytest.raises(ValueError):
        kvc.encode_pages(x, fmt, ones, backend="jnp", quantum=E)
