"""MLA (multi-head latent attention) and deepseek-v2-236b in the port
against the JAX package's, from the same weights.

deepseek-v2 brings MLA — queries through a rank-1,536 bottleneck, keys and
values up-projected from a 512-wide latent beside a shared 64-wide rotary
key — and an MoE with 2 shared experts beside 160 routed ones (top-6;
smoke: 8 and 1, top-2), an untied unembedding and 4 microbatches a step.
Train and prefill take the expanded form (per-head K and V from the
latent, one attention call over q/k of width 192 and v of 128); decode
takes the absorbed form against the two latent caches.  Held:

* every field of the config and its full-size total and active parameter
  counts equal to the reference's;
* at smoke size, for each cache width (``kv_cache_bits`` 16: fp32 caches at
  smoke size; 8: int8 on the ⟨3, 5⟩ grid): the prefill logits and 3
  absorbed decode steps' logits within ``TOL`` of the reference's, the
  latent caches after prefill and after the steps within ``TOL`` (fp32) or
  bit-equal (int8);
* the absorbed decode equal to the expanded form over the same positions
  within ``DECODE_RTOL`` of the largest magnitude (fp32), at smoke size and
  at one layer's real per-head widths;
* 3 SGD steps under nearest rounding over the config's 4 microbatches,
  under ``remat="full"`` and ``"dots"``: ⟨IL, FL⟩ of every domain identical
  at every step, the loss to 1e-4 relative (as
  ``tests/test_torch_train.py``); ``dots`` bit-equal to ``full`` on one
  thread;
* ``params_from_jax`` takes the MLA keys; the serving CLI refuses the
  config with the reference's message (MLA has no paged path in either
  package); the training CLI smoke-runs it on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, registry, transformer
from repro_torch.models.common import (init_params, is_def, padded_vocab)
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.serve import Engine, EngineConfig, PagedLayout
from test_torch_jaxref import (one_thread,  # noqa: F401
                               run_reference, unflatten)

ARCH = "deepseek_v2_236b"
# the analytic counts at full size (vocab unpadded)
FULL_PARAMS, ACTIVE_PARAMS = 239_375_447_040, 21_376_496_640
TOL = 1e-4
# absorbed vs expanded decode, fp32: (q·W_uk)·c against q·(W_uk·c) — the
# same products summed in another order; measured ~2e-7 at smoke size
DECODE_RTOL = 1e-5
LOSS_RTOL = 1e-4
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
MAX_SEQ = 12
# 3 steps of 8 sequences over the config's 4 microbatches
LM = dict(steps=3, seq=16, batch=8)
REMATS = ("full", "dots")

_rng = np.random.default_rng(21)
ARRAYS = {"tokens": _rng.integers(1, 256, (2, 8)).astype(np.int32),
          "steps": _rng.integers(1, 256, (2, 3)).astype(np.int32)}


def _cfg(**kw):
    return dataclasses.replace(smoke(get_config(ARCH)), **kw)


def _accum():
    return {"train_accum": get_config(ARCH).train_accum}


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "config", "tag": "cfg", "kw": {"archs": [ARCH]}},
            {"job": "mla_model", "tag": "model",
             "kw": {"seed": 0, "max_seq": MAX_SEQ}},
            {"job": "lm_train", "tag": "lm", "kw": dict(
                LM, remat="full", arch=ARCH, overrides=_accum())},
            {"job": "serve_refusal", "tag": "serve", "kw": {"arch": ARCH}}]
    return run_reference(jobs, {f"model/{k}": v for k, v in ARRAYS.items()})


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_fields_and_full_size_counts_match_reference(ref):
    cfg = get_config(ARCH)
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == json.loads(
        str(ref[f"cfg/{ARCH}/fields"]))
    assert cfg.n_params() == float(ref[f"cfg/{ARCH}/n_params"]) == FULL_PARAMS
    assert cfg.n_active_params() == float(
        ref[f"cfg/{ARCH}/n_active_params"]) == ACTIVE_PARAMS
    # the declarations alone (nothing allocated): their sizes less the
    # vocabulary padding are the count plus the two MLA norm scales a layer,
    # which the analytic count leaves out, as the reference's does
    defs = registry(cfg.family).model_defs(cfg)
    leaves = [d for _, d in tree_lib.leaves_with_path(defs)]
    assert all(is_def(d) for d in leaves)
    pad = 2 * (padded_vocab(cfg.vocab) - cfg.vocab) * cfg.d_model
    norms = cfg.n_layers * (cfg.q_lora_rank + cfg.kv_lora_rank)
    assert sum(int(np.prod(d.shape)) for d in leaves) - pad == \
        FULL_PARAMS + norms


def test_params_from_jax_takes_the_mla_keys(ref):
    cfg = _cfg(dtype="bfloat16")
    params = params_from_jax(unflatten(ref, "model/params/"), cfg, "cpu")
    attn = params["layers"]["attn"]
    assert set(attn) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "w_uk",
                         "w_uv", "wo"}
    L, kvr, H = cfg.n_layers, cfg.kv_lora_rank, cfg.n_heads
    assert attn["w_uk"].shape == (L, kvr, H, cfg.qk_nope_dim)
    assert attn["w_uv"].shape == (L, kvr, H, cfg.v_head_dim)
    assert attn["wq_b"].shape == (L, cfg.q_lora_rank,
                                  H * (cfg.qk_nope_dim + cfg.qk_rope_dim))
    # the norm scales stay fp32 at a bf16 working dtype, as declared
    assert attn["q_norm"].dtype == attn["kv_norm"].dtype == torch.float32
    assert attn["w_uk"].dtype == torch.bfloat16
    assert torch.equal(attn["w_uk"], torch.from_numpy(
        ref["model/params/layers/attn/w_uk"]).to(torch.bfloat16))


@pytest.mark.parametrize("bits", [16, 8])
def test_prefill_and_absorbed_decode_match_reference(ref, bits):
    cfg = _cfg(kv_cache_bits=bits)
    mod = registry(cfg.family)
    params = params_from_jax(unflatten(ref, "model/params/"), cfg, "cpu")
    logits, cache, pos = mod.prefill(cfg, params, _t(ARRAYS["tokens"]),
                                     MAX_SEQ)
    L, B = cfg.n_layers, ARRAYS["tokens"].shape[0]
    dt = torch.int8 if bits == 8 else torch.float32
    assert [tuple(c.shape) for c in cache] == [
        (L, B, MAX_SEQ, cfg.kv_lora_rank), (L, B, MAX_SEQ, cfg.qk_rope_dim)]
    assert all(c.dtype == dt for c in cache)
    assert [c.shape for c in cache] == [
        c.shape for c in mod.init_cache(cfg, B, MAX_SEQ, "cpu")]
    assert np.max(np.abs(logits.numpy() - ref[f"model/{bits}/prefill_logits"])
                  ) <= TOL

    def hold(got, name):
        want = ref[f"model/{bits}/{name}"]
        if bits == 8:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            assert np.max(np.abs(got.numpy() - want)) <= TOL, name

    hold(cache[0], "prefill_cc")
    hold(cache[1], "prefill_cr")
    for i in range(ARRAYS["steps"].shape[1]):
        lg, cache = mod.decode_step(cfg, params,
                                    _t(ARRAYS["steps"][:, i:i + 1]), cache, pos)
        pos = pos + 1
        want = ref[f"model/{bits}/decode_logits/{i}"]
        assert np.max(np.abs(lg.numpy() - want)) <= TOL, i
        assert np.all(lg.numpy()[:, cfg.vocab:] == np.float32(-1e30))
    hold(cache[0], "decode_cc")
    hold(cache[1], "decode_cr")
    # the steps wrote their latents at positions 8, 9 and 10
    assert bool((cache[0][:, :, 8:11] != 0).any(dim=-1).all())
    assert not bool(cache[0][:, :, 11:].any())


@pytest.mark.parametrize("geom", ["smoke", "widths"])
def test_absorbed_decode_equals_the_expanded_form(geom):
    """One MLA layer: the decode step at position S over the latent cache of
    the first S positions equals the expanded form's last row over S + 1."""
    kw = ({} if geom == "smoke" else
          dict(q_lora_rank=96, kv_lora_rank=512, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128))
    cfg = _cfg(**kw)
    gen = torch.Generator().manual_seed(5)
    p = init_params(attention.mla_defs(cfg, torch.float32), "cpu", gen)
    B, S = 2, 9
    x = torch.randn(B, S + 1, cfg.d_model, generator=gen)
    positions = torch.arange(S + 1)[None]
    full, _ = attention.mla_apply(cfg, p, x, positions=positions,
                                  mode="prefill")
    _, cache = attention.mla_apply(cfg, p, x[:, :S], positions=positions[:, :S],
                                   mode="prefill")
    cache = tuple(torch.nn.functional.pad(c, (0, 0, 0, 3)) for c in cache)
    at = torch.full((B,), S, dtype=torch.int32)
    out, new = attention.mla_apply(cfg, p, x[:, S:], positions=at[:, None],
                                   mode="decode", cache=cache, cache_pos=at)
    err = float((out[:, 0] - full[:, -1]).abs().max())
    assert err <= DECODE_RTOL * float(full[:, -1].abs().max()), err
    assert new[0] is cache[0]                  # written in place
    assert bool(cache[0][:, S].any()) and not bool(cache[0][:, S + 1:].any())


def _train(cfg, params, steps):
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(cfg.family).loss_fn(cfg), opt,
                                  qcfg, accum_steps=cfg.train_accum)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=LM["seq"],
                                         global_batch=LM["batch"], seed=0))
    hist = {k: [] for k in FMTS + ("loss", "aux_loss")}
    for i in range(steps):
        state, m = step(state, data.batch(i))
        for k in hist:
            hist[k].append(float(m[k]))
    return hist


def _lm_params(ref, cfg):
    return params_from_jax(unflatten(ref, "lm/params/"), cfg, "cpu",
                           training=True)


@pytest.mark.parametrize("remat", REMATS)
def test_lm_steps_over_four_microbatches_match_reference(ref, remat):
    cfg = _cfg(remat=remat, **_accum())
    assert cfg.train_accum == 4
    hist = _train(cfg, _lm_params(ref, cfg), LM["steps"])
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"lm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref["lm/hist/loss"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(hist["loss"])) and all(
        v > 0 for v in hist["aux_loss"])


def test_remat_dots_is_bit_equal_to_full(ref, one_thread):  # noqa: F811
    runs = {}
    for remat in REMATS:
        cfg = _cfg(remat=remat, **_accum())
        runs[remat] = _train(cfg, _lm_params(ref, cfg), 2)
    assert runs["dots"] == runs["full"]


def test_serve_cli_refuses_mla_with_the_reference_message(ref):
    want = str(ref["serve/message"])
    assert want.startswith("deepseek-v2-236b: family 'moe' has no paged")
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "1"])
    assert str(e.value) == want
    cfg = _cfg()
    params = init_params(transformer.model_defs(cfg), "cpu",
                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mla=True"):
        Engine(cfg, params, EngineConfig(layout=PagedLayout(
            page_size=4, n_pages=8, batch_slots=2, max_pages_per_seq=4,
            max_prompt=8)), device="cpu")


def test_train_cli_smoke_on_the_cpu():
    out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "4", "--seq", "16",
                          "--log-every", "1"])
    assert out["params"] == _cfg().n_params()
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) and h["aux_loss"] > 0
               for h in out["history"])
