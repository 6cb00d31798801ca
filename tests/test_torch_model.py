"""The port's dense decoder against the JAX package's, from the same weights.

The reference's smoke parameters (2 layers, d=64, 4 heads / 2 KV heads,
Dh=16, vocab 256, fp32) cross over through ``params_from_jax``.  Held:
prefill logits, contiguous decode logits and ``decode_step_paged`` logits
within 1e-4 absolute (fp32; the two frameworks order their matrix products
and reductions differently), and the int8 pools after a paged step byte-equal
outside the trash page.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.models.common import init_params, padded_vocab
from test_torch_jaxref import run_reference, unflatten

CFG = smoke(get_config("llama3_2_3b"))
MOD = registry(CFG.family)
LAYOUT = dict(page_size=4, n_pages=8, batch_slots=3, max_pages_per_seq=4,
              max_prompt=8)
N_TOT, PS, TRASH = 9, 4, 8
TOL = 1e-4

_rng = np.random.default_rng(3)
_pool = (CFG.n_layers, N_TOT, PS, CFG.n_kv_heads, CFG.head_dim)
_il = _rng.integers(2, 5, (2, CFG.n_layers, N_TOT)).astype(np.int32)
ARRAYS = {
    "tokens": _rng.integers(1, CFG.vocab, (2, 8)).astype(np.int32),
    "next": _rng.integers(1, CFG.vocab, (2, 1)).astype(np.int32),
    "k_pages": _rng.integers(-100, 100, _pool).astype(np.int8),
    "v_pages": _rng.integers(-100, 100, _pool).astype(np.int8),
    "k_fmt": np.stack([_il[0], 8 - _il[0]], axis=-1),
    "v_fmt": np.stack([_il[1], 8 - _il[1]], axis=-1),
    # rows 0 and 1 are live (one mid-page, one opening a new page); row 2 is
    # an inactive slot riding along at position 0 on the trash page
    "ptab": np.array([[2, 5, TRASH, TRASH], [7, 1, 3, TRASH],
                      [TRASH] * 4], np.int32),
    "ppos": np.array([6, 8, 0], np.int32),
    "ptoks": _rng.integers(1, CFG.vocab, (3, 1)).astype(np.int32),
}


@pytest.fixture(scope="module")
def ref():
    return run_reference(
        [{"job": "model", "tag": "m", "kw": {"seed": 0, "layout": LAYOUT}}],
        {f"m/{k}": v for k, v in ARRAYS.items()})


@pytest.fixture(scope="module")
def params(ref):
    return params_from_jax(unflatten(ref, "m/params/"), CFG, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_params_cross_over_with_the_reference_keys(ref, params):
    assert set(params) == {"embed", "layers", "final_norm"}
    assert set(params["layers"]) == {"norm1", "norm2", "attn", "mlp"}
    assert params["layers"]["attn"]["wq"].shape == (2, 64, 64)
    assert params["embed"]["tok"].shape == (padded_vocab(CFG.vocab), 64)
    np.testing.assert_array_equal(params["layers"]["mlp"]["w_gate"].numpy(),
                                  ref["m/params/layers/mlp/w_gate"])
    n = sum(v.size for k, v in ref.items() if k.startswith("m/params/"))
    pad = (padded_vocab(CFG.vocab) - CFG.vocab) * CFG.d_model
    assert MOD.count_params(CFG) == n - pad


def test_params_from_jax_rejects_a_wrong_tree(ref):
    tree = unflatten(ref, "m/params/")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(bad, CFG, "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({"embed": tree["embed"]}, CFG, "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(tree, CFG)          # default device: the card


def test_prefill_logits_match_reference(ref, params):
    logits, cache, pos = MOD.prefill(CFG, params, _t(ARRAYS["tokens"]), 12)
    assert logits.dtype == torch.float32
    assert np.max(np.abs(logits.numpy() - ref["m/prefill_logits"])) <= TOL
    assert cache[0].shape == ref["m/prefill_ck"].shape
    assert np.max(np.abs(cache[0].numpy() - ref["m/prefill_ck"])) <= TOL
    assert np.max(np.abs(cache[1].numpy() - ref["m/prefill_cv"])) <= TOL
    assert pos.tolist() == [8, 8]
    # padded vocabulary columns carry no probability
    assert np.all(logits.numpy()[:, CFG.vocab:] == np.float32(-1e30))
    assert np.array_equal(logits.argmax(-1).numpy(),
                          ref["m/prefill_logits"].argmax(-1))


def test_contiguous_decode_logits_match_reference(ref, params):
    _, cache, pos = MOD.prefill(CFG, params, _t(ARRAYS["tokens"]), 12)
    lg, cache2 = MOD.decode_step(CFG, params, _t(ARRAYS["next"]), cache, pos)
    assert np.max(np.abs(lg.numpy() - ref["m/decode_logits"])) <= TOL
    assert cache2[0] is cache[0]            # written in place


def test_paged_decode_step_matches_reference(ref, params):
    cache = tuple(_t(ARRAYS[k]) for k in ("k_pages", "v_pages", "k_fmt",
                                          "v_fmt"))
    lg, new = MOD.decode_step_paged(CFG, params, _t(ARRAYS["ptoks"]), cache,
                                    _t(ARRAYS["ptab"]), _t(ARRAYS["ppos"]))
    live = [0, 1]
    assert np.max(np.abs(lg.numpy()[live] - ref["m/paged_logits"][live])) <= TOL
    assert np.all(np.isfinite(lg.numpy()[:, :CFG.vocab]))
    np.testing.assert_array_equal(new[0].numpy()[:, :TRASH],
                                  ref["m/paged_k"][:, :TRASH])
    np.testing.assert_array_equal(new[1].numpy()[:, :TRASH],
                                  ref["m/paged_v"][:, :TRASH])
    # the step wrote the new tokens' K/V: row 0 at page 5 offset 2, row 1 at
    # page 3 offset 0
    assert not np.array_equal(new[0].numpy()[:, 5, 2], ARRAYS["k_pages"][:, 5, 2])
    assert not np.array_equal(new[0].numpy()[:, 3, 0], ARRAYS["k_pages"][:, 3, 0])


def test_init_params_is_a_function_of_the_seed():
    defs = MOD.model_defs(CFG)
    gen = lambda s: torch.Generator(device="cpu").manual_seed(s)
    a = init_params(defs, "cpu", gen(0))
    b = init_params(defs, "cpu", gen(0))
    c = init_params(defs, "cpu", gen(1))
    wq = a["layers"]["attn"]["wq"]
    assert torch.equal(wq, b["layers"]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"]["attn"]["wq"])
    # truncated normal with fan-in scaling: |w| <= 2 / sqrt(fan_in)
    assert wq.abs().max() <= 2.0 / 8.0 + 1e-6 and 0.08 < wq.std() < 0.125
    assert torch.equal(a["final_norm"], torch.ones(64))
    assert a["embed"]["tok"].std() == pytest.approx(0.02, rel=0.05)


def test_full_size_config_is_declared_without_allocating():
    cfg = get_config("llama3.2-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (28, 3072, 24, 8, 128, 8192,
                                                   128256)
    assert cfg.activation_dtype() == torch.bfloat16
    assert 3.1e9 < cfg.n_params() < 3.3e9
    defs = MOD.model_defs(cfg)
    assert defs["layers"]["mlp"]["w_in"].shape == (28, 3072, 8192)
    assert defs["layers"]["mlp"]["w_in"].dtype == torch.bfloat16
    assert defs["layers"]["norm1"].dtype == torch.float32


@pytest.mark.parametrize("what", ["moe", "mla", "family", "flash"])
def test_unported_parts_say_so(what):
    import dataclasses
    from repro_torch.models import attention
    if what == "moe":
        with pytest.raises(NotImplementedError):
            MOD.model_defs(dataclasses.replace(CFG, n_experts=4))
    elif what == "mla":
        with pytest.raises(NotImplementedError):
            MOD.count_params(dataclasses.replace(CFG, mla=True))
    elif what == "family":
        with pytest.raises(NotImplementedError):
            registry("ssm")
        with pytest.raises(ValueError):
            registry("nope")
    else:
        q = torch.zeros(1, 4097, 1, 1).expand(1, 4097, 1, 8)
        k = torch.zeros(1, 2049, 1, 1).expand(1, 2049, 1, 8)
        with pytest.raises(NotImplementedError):
            attention.sdpa(q, k, k, causal=True, scale=1.0)
