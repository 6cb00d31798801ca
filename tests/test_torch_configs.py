"""The other configs — gemma-7b, mistral-large-123b, nemotron-4-340b
(dense), qwen3-moe-30b-a3b (MoE) and internvl2-26b (VLM) — in the port
against the JAX package's, from the same weights.

Each config brings something llama3.2-3b does not: gemma's tanh-GELU
gated MLP, Dh = 256 and multi-head attention (G = 1); mistral's untied
unembedding and G = 12; nemotron's squared-ReLU, non-gated MLP, untied
unembedding and G = 12 at Dh = 192; qwen3-moe's MoE layers (128 experts,
top-8; smoke: 8, top-2) and G = 8; internvl2's vision prefix (patch
embeddings prepended to the tokens), untied unembedding and G = 6; and
gradient accumulation over 2, 4 and 8 microbatches.  Held, for each config:

* (a) every field of the config equals the reference's, and the analytic
  full-size parameter count equals the reference's, from declarations
  alone (nothing allocated);
* (b) at smoke size, (c) at the config's real head geometry (``smoke``
  flattens it to Dh = 16, G <= 2; the overrides restore H, KV and Dh):
  prefill, contiguous-decode and paged-decode logits within 1e-4 of the
  reference from its converted parameters, and the int8 pools byte-equal
  after a paged step, as ``tests/test_torch_model.py`` holds llama
  (internvl2's prompt after a nonzero vision prefix from a numpy seed);
* (d) 3 SGD steps under nearest rounding at smoke size, split into the full
  config's ``train_accum`` microbatches: ⟨IL, FL⟩ of every domain identical
  at every step, the loss to 1e-4 relative (as ``tests/test_torch_train.py``;
  internvl2 with a vision prefix on every batch; qwen3-moe, whose
  ``train_accum`` is 1, in ``tests/test_torch_moe.py``);
* (e) the serving engine's greedy tokens and page-format spread on a short
  seeded trace identical to the reference engine's (internvl2 trains only:
  neither engine serves it).

Also: the serving and training CLIs smoke-run each config on the CPU, and
the engine holds one fp32 cast of an untied ``unembed`` table, which changes
no logit.
"""

import dataclasses
import json
import math

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
from repro_torch.models import registry
from repro_torch.models.common import (UNEMBED_F32, init_params, is_def,
                                       padded_vocab, unembed)
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.serve import Engine, EngineConfig, PagedLayout, synthetic_trace
from test_torch_jaxref import run_reference, unflatten

ARCHS = ("gemma_7b", "mistral_large_123b", "nemotron_4_340b",
         "qwen3_moe_30b_a3b", "internvl2_26b")
# the configs the serving engine takes (the VLM trains only)
SERVE_ARCHS = tuple(a for a in ARCHS if a != "internvl2_26b")
# the configs that accumulate gradients (qwen3-moe's train_accum is 1)
ACCUM_ARCHS = tuple(a for a in ARCHS if a != "qwen3_moe_30b_a3b")
# full-size parameter counts (the analytic count, vocab unpadded)
FULL_PARAMS = {"gemma_7b": 8_537_680_896, "mistral_large_123b": 122_610_069_504,
               "nemotron_4_340b": 341_025_638_400,
               "qwen3_moe_30b_a3b": 30_220_945_408,
               "internvl2_26b": 19_861_260_288}
# each config's real head geometry at smoke width: (H, KV, Dh) with its G
HEADS = {"gemma_7b": dict(n_heads=2, n_kv_heads=2, head_dim=256),
         "mistral_large_123b": dict(n_heads=12, n_kv_heads=1, head_dim=128),
         "nemotron_4_340b": dict(n_heads=12, n_kv_heads=1, head_dim=192),
         "qwen3_moe_30b_a3b": dict(n_heads=8, n_kv_heads=1, head_dim=128),
         "internvl2_26b": dict(n_heads=6, n_kv_heads=1, head_dim=128)}
GEOMS = ("smoke", "heads")
TOL = 1e-4
LOSS_RTOL = 1e-4
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")

LAYOUT = dict(page_size=4, n_pages=8, batch_slots=3, max_pages_per_seq=4,
              max_prompt=8)
N_TOT, PS, TRASH = 9, 4, 8
ENGINE_LAYOUT = dict(page_size=4, n_pages=24, batch_slots=4,
                     max_pages_per_seq=8, max_prompt=16)
TRACE = dict(n=6, prompt_lens=[3, 12], new_tokens=[2, 8], mean_gap=0.5,
             seed=1, kv_bits=8)
# 3 steps of 8 sequences (nemotron's 8 microbatches take one each)
LM = dict(steps=3, seq=16, batch=8, remat="full")


def _overrides(arch, geom):
    return HEADS[arch] if geom == "heads" else None


def _cfg(arch, geom="smoke", **kw):
    return dataclasses.replace(smoke(get_config(arch)),
                               **(_overrides(arch, geom) or {}), **kw)


def _accum(arch):
    return {"train_accum": get_config(arch).train_accum}


def _vision(cfg, batch, seed):
    """A VLM's vision prefix (batch, n_patches, d) from a numpy seed; no
    entry for any other config."""
    if cfg.family != "vlm":
        return {}
    rng = np.random.default_rng(seed)
    return {"vision_embeds": rng.standard_normal(
        (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def _model_arrays(cfg, seed):
    rng = np.random.default_rng(seed)
    pool = (cfg.n_layers, N_TOT, PS, cfg.n_kv_heads, cfg.head_dim)
    il = rng.integers(2, 5, (2, cfg.n_layers, N_TOT)).astype(np.int32)
    return {**_vision(cfg, 2, seed + 100),
        "tokens": rng.integers(1, cfg.vocab, (2, 8)).astype(np.int32),
        "next": rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32),
        "k_pages": rng.integers(-100, 100, pool).astype(np.int8),
        "v_pages": rng.integers(-100, 100, pool).astype(np.int8),
        "k_fmt": np.stack([il[0], 8 - il[0]], axis=-1),
        "v_fmt": np.stack([il[1], 8 - il[1]], axis=-1),
        # rows 0 and 1 live (one mid-page, one opening a new page), row 2 an
        # inactive slot on the trash page
        "ptab": np.array([[2, 5, TRASH, TRASH], [7, 1, 3, TRASH],
                          [TRASH] * 4], np.int32),
        "ppos": np.array([6, 8, 0], np.int32),
        "ptoks": rng.integers(1, cfg.vocab, (3, 1)).astype(np.int32),
    }


ARRAYS = {(arch, geom): _model_arrays(_cfg(arch, geom), 11 + i)
          for i, (arch, geom) in enumerate((a, g) for a in ARCHS
                                           for g in GEOMS)}
LM_VISION = {arch: _vision(_cfg(arch), LM["batch"], 60) for arch in ARCHS}


@pytest.fixture(scope="module")
def ref():
    """One reference child for every config: the config job, the model at
    both geometries, the engine and the training steps."""
    jobs = [{"job": "config", "tag": "cfg", "kw": {"archs": list(ARCHS)}}]
    arrays = {}
    for arch in ARCHS:
        for geom in GEOMS:
            tag = f"{arch}/{geom}"
            jobs.append({"job": "model", "tag": tag, "kw": {
                "seed": 0, "layout": LAYOUT, "arch": arch,
                "overrides": _overrides(arch, geom)}})
            arrays.update({f"{tag}/{k}": v
                           for k, v in ARRAYS[(arch, geom)].items()})
        if arch in SERVE_ARCHS:
            jobs.append({"job": "engine", "tag": f"{arch}/engine", "kw": {
                "seed": 0, "layout": ENGINE_LAYOUT,
                "traces": {"int8": TRACE}, "arch": arch}})
        if arch in ACCUM_ARCHS:
            jobs.append({"job": "lm_train", "tag": f"{arch}/lm", "kw": dict(
                LM, arch=arch, overrides=_accum(arch))})
            arrays.update({f"{arch}/lm/{k}": v
                           for k, v in LM_VISION[arch].items()})
    return run_reference(jobs, arrays)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_full_size_count_match_reference(ref, arch):
    cfg = get_config(arch)
    want = json.loads(str(ref[f"cfg/{arch}/fields"]))
    got = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert got == want
    assert cfg.n_params() == float(ref[f"cfg/{arch}/n_params"])
    assert cfg.n_params() == FULL_PARAMS[arch]
    # the declarations alone: nothing is allocated, and their sizes less
    # the vocabulary padding give the same count
    defs = registry(cfg.family).model_defs(cfg)
    leaves = [d for _, d in tree_lib.leaves_with_path(defs)]
    assert all(is_def(d) for d in leaves)
    pad = (padded_vocab(cfg.vocab) - cfg.vocab) * cfg.d_model
    n_tables = 1 if cfg.tie_embed else 2
    assert sum(math.prod(d.shape) for d in leaves) - n_tables * pad \
        == FULL_PARAMS[arch]
    assert ("unembed" in defs["embed"]) == (not cfg.tie_embed)


# ---------------------------------------------------------------------------
# (b), (c) the model at smoke size and at the real head geometry
# ---------------------------------------------------------------------------

def _params(ref, arch, geom):
    return params_from_jax(unflatten(ref, f"{arch}/{geom}/params/"),
                           _cfg(arch, geom), "cpu")


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(ref, arch, geom):
    cfg, tag, a = _cfg(arch, geom), f"{arch}/{geom}", ARRAYS[(arch, geom)]
    mod = registry(cfg.family)
    params = _params(ref, arch, geom)
    vis = _t(a["vision_embeds"]) if "vision_embeds" in a else None
    n_vis = 0 if vis is None else vis.shape[1]
    logits, cache, pos = mod.prefill(cfg, params, _t(a["tokens"]), 12 + n_vis,
                                     vision_embeds=vis)
    assert int(pos[0]) == a["tokens"].shape[1] + n_vis
    assert np.max(np.abs(logits.numpy() - ref[f"{tag}/prefill_logits"])) <= TOL
    assert np.max(np.abs(cache[0].numpy() - ref[f"{tag}/prefill_ck"])) <= TOL
    assert np.max(np.abs(cache[1].numpy() - ref[f"{tag}/prefill_cv"])) <= TOL
    assert np.all(logits.numpy()[:, cfg.vocab:] == np.float32(-1e30))
    lg, _ = mod.decode_step(cfg, params, _t(a["next"]), cache, pos)
    assert np.max(np.abs(lg.numpy() - ref[f"{tag}/decode_logits"])) <= TOL


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(ref, arch, geom):
    cfg, tag, a = _cfg(arch, geom), f"{arch}/{geom}", ARRAYS[(arch, geom)]
    params = _params(ref, arch, geom)
    cache = tuple(_t(a[k]) for k in ("k_pages", "v_pages", "k_fmt", "v_fmt"))
    lg, new = registry(cfg.family).decode_step_paged(
        cfg, params, _t(a["ptoks"]), cache, _t(a["ptab"]), _t(a["ppos"]))
    live = [0, 1]
    assert np.max(np.abs(lg.numpy()[live] - ref[f"{tag}/paged_logits"][live])
                  ) <= TOL
    assert np.all(np.isfinite(lg.numpy()[:, :cfg.vocab]))
    np.testing.assert_array_equal(new[0].numpy()[:, :TRASH],
                                  ref[f"{tag}/paged_k"][:, :TRASH])
    np.testing.assert_array_equal(new[1].numpy()[:, :TRASH],
                                  ref[f"{tag}/paged_v"][:, :TRASH])
    # the step wrote row 0's token at page 5 slot 2
    assert not np.array_equal(new[0].numpy()[:, 5, 2], a["k_pages"][:, 5, 2])


# ---------------------------------------------------------------------------
# (d) training over the config's microbatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_lm_steps_with_accumulation_match_reference(ref, arch):
    cfg = _cfg(arch, remat=LM["remat"], **_accum(arch))
    assert cfg.train_accum == get_config(arch).train_accum > 1
    params = params_from_jax(unflatten(ref, f"{arch}/lm/params/"), cfg, "cpu",
                             training=True)
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(cfg.family).loss_fn(cfg), opt,
                                  qcfg, accum_steps=cfg.train_accum)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=LM["seq"],
                                         global_batch=LM["batch"], seed=0))
    extras = {k: _t(v) for k, v in LM_VISION[arch].items()}
    hist = {k: [] for k in FMTS + ("loss",)}
    for i in range(LM["steps"]):
        state, m = step(state, dict(data.batch(i), **extras))
        for k in hist:
            hist[k].append(float(m[k]))
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"{arch}/lm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref[f"{arch}/lm/hist/loss"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(hist["loss"]))


# ---------------------------------------------------------------------------
# (e) the serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_engine_tokens_and_spread_match_reference(ref, arch):
    cfg = _cfg(arch)
    params = params_from_jax(unflatten(ref, f"{arch}/engine/params/"), cfg,
                             "cpu")
    reqs = synthetic_trace(TRACE["n"], cfg.vocab,
                           prompt_lens=tuple(TRACE["prompt_lens"]),
                           new_tokens=tuple(TRACE["new_tokens"]),
                           mean_gap=TRACE["mean_gap"], seed=TRACE["seed"])
    eng = Engine(cfg, params, EngineConfig(layout=PagedLayout(**ENGINE_LAYOUT),
                                           kv_bits=TRACE["kv_bits"]),
                 device="cpu")
    rep = eng.run(reqs)
    for r in reqs:
        assert rep.tokens[r.rid] == ref[f"{arch}/engine/int8/tokens/{r.rid}"
                                        ].tolist(), r.rid
        assert len(rep.tokens[r.rid]) == r.max_new
    assert rep.format_spread == json.loads(
        str(ref[f"{arch}/engine/int8/spread"]))


# ---------------------------------------------------------------------------
# the engine's held fp32 table, and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mistral_large_123b", "nemotron_4_340b"])
def test_engine_holds_one_fp32_cast_of_an_untied_table(arch):
    """A bf16 model with an untied ``unembed`` (the full-size case): the
    engine parks one fp32 cast of it, as it does the tied table, and the
    logits equal those of the per-call cast bit for bit."""
    cfg = _cfg(arch, dtype="bfloat16")
    mod = registry(cfg.family)
    p16 = init_params(mod.model_defs(cfg), "cpu",
                      torch.Generator(device="cpu").manual_seed(0))
    assert p16["embed"]["unembed"].dtype == torch.bfloat16
    eng = Engine(cfg, p16, EngineConfig(
        layout=PagedLayout(**ENGINE_LAYOUT)), device="cpu")
    held = eng.params["embed"]
    assert set(held) == {"tok", "unembed", UNEMBED_F32}   # one cast, no other
    assert held[UNEMBED_F32].dtype == torch.float32
    assert torch.equal(held[UNEMBED_F32], p16["embed"]["unembed"].float())
    assert UNEMBED_F32 not in p16["embed"]        # the caller's dict untouched
    x = torch.randn(3, 1, cfg.d_model).to(torch.bfloat16)
    a = unembed(x, p16["embed"], cfg.vocab)
    b = unembed(x, held, cfg.vocab)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    # an engine over the held parameters makes no second cast
    again = Engine(cfg, eng.params, EngineConfig(
        layout=PagedLayout(**ENGINE_LAYOUT)), device="cpu")
    assert again.params["embed"][UNEMBED_F32] is held[UNEMBED_F32]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_smoke_on_the_cpu(arch, capsys):
    serve_argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                  "4", "--slots", "2", "--page-size", "4", "--max-prompt", "8",
                  "--max-new", "6"]
    if arch in SERVE_ARCHS:
        rep = serve_cli.main(serve_argv)
        assert rep.metrics["total_tokens"] > 0
        assert "tok/s" in capsys.readouterr().out
    else:                       # as the reference's CLI, it refuses the VLM
        with pytest.raises(SystemExit, match="paged"):
            serve_cli.main(serve_argv)
    out = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "8", "--seq", "16",
                          "--log-every", "1"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert ("aux_loss" in out["history"][0]) == (arch == "qwen3_moe_30b_a3b")


def test_train_setup_takes_a_config_cut_in_depth():
    """``launch.train.main(cfg=...)``: the model built is the config given,
    not ``--arch``'s (no CLI flag sets the depth)."""
    cfg = dataclasses.replace(_cfg("mistral_large_123b"), n_layers=1)
    out = train_cli.main(["--arch", "mistral_large_123b", "--device", "cpu",
                          "--steps", "1", "--batch", "4", "--seq", "8"],
                         cfg=cfg)
    assert out["params"] == cfg.n_params()
    assert len(out["history"]) == 1
