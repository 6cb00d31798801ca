"""The MoE layer and qwen3-moe-30b-a3b in the port against the JAX
package's, from the same weights and numpy inputs.

* The router and the einsum dispatch (``models/moe.py``) on x (B, S, D)
  from a numpy seed, at smoke size: the top-k expert indices, every (token,
  k) choice's capacity slot and keep flag, and the capacity itself
  **exactly**; the routing weights, ``moe_apply``'s output and the
  load-balance loss within ``TOL`` (fp32, summed in another order).  Cases:
  the smoke config, a capacity factor small enough that choices are
  dropped, and one shared expert.  The inputs are tie-free — a test says
  so: ``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
  probabilities.
* qwen3-moe smoke: the serving engine's greedy tokens and page-format
  spread with ``kv_bits`` 8 and None; 3 SGD steps under nearest rounding
  (formats identical, the loss — the load-balance loss included — to
  ``LOSS_RTOL``); the active-parameter count at full size exactly.
* The fp32 router: declared fp32 at any working dtype, left fp32 by the
  training compute cast and by ``params_from_jax``; the load-balance loss
  leaves a checkpointed block once, under every ``remat``.

The model's prefill, decode and paged logits (smoke size and G = 8 at
Dh = 128), the configs' fields and full-size counts, and the CLIs are held
in ``tests/test_torch_configs.py``.
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
from repro_torch.models import moe, registry, transformer
from repro_torch.models.common import init_params, kept_f32
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.serve import Engine, EngineConfig, PagedLayout, synthetic_trace
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

ARCH = "qwen3_moe_30b_a3b"
CFG = smoke(get_config(ARCH))
TOL = 1e-5
LOSS_RTOL = 1e-4
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
# full size: 30.2 B parameters, 3.04 B of them active a token
FULL_ACTIVE = 3_041_855_488
CASES = {"smoke": None, "drops": {"capacity_factor": 0.25},
         "shared": {"n_shared_experts": 1}}
X_SHAPE = (2, 24, CFG.d_model)          # T = 48 tokens, 96 choices
# a tie is a gap below this between a token's k-th and (k+1)-th probability
TIE_GAP = 1e-6
ENGINE_LAYOUT = dict(page_size=4, n_pages=24, batch_slots=4,
                     max_pages_per_seq=8, max_prompt=16)
TRACES = {"int8": dict(n=6, prompt_lens=[3, 12], new_tokens=[2, 8],
                       mean_gap=0.5, seed=1, kv_bits=8),
          "fp32": dict(n=6, prompt_lens=[3, 12], new_tokens=[2, 8],
                       mean_gap=0.5, seed=1, kv_bits=None)}
LM = dict(steps=3, seq=16, batch=4)

X = {c: np.random.default_rng(50 + i).standard_normal(X_SHAPE).astype(
     np.float32) for i, c in enumerate(CASES)}


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "moe", "tag": f"moe/{c}", "kw": {
        "seed": i, "arch": ARCH, "overrides": o}}
        for i, (c, o) in enumerate(CASES.items())]
    jobs += [{"job": "engine", "tag": "engine", "kw": {
                 "seed": 0, "layout": ENGINE_LAYOUT, "traces": TRACES,
                 "arch": ARCH}},
             {"job": "lm_train", "tag": "lm", "kw": dict(
                 LM, remat="full", arch=ARCH)}]
    return run_reference(jobs, {f"moe/{c}/x": x for c, x in X.items()})


def _cfg(case):
    return dataclasses.replace(CFG, **(CASES[case] or {}))


def _moe_params(ref, case):
    return tree_lib.map_tree(torch.from_numpy,
                             unflatten(ref, f"moe/{case}/params/"))


@pytest.mark.parametrize("case", CASES)
def test_router_indices_slots_and_keep_match_reference_exactly(ref, case):
    cfg, tag = _cfg(case), f"moe/{case}"
    x2 = torch.from_numpy(X[case]).reshape(-1, cfg.d_model)
    top_w, top_i, probs = moe._router(cfg, _moe_params(ref, case)["router"],
                                      x2)
    # the inputs are tie-free: torch.topk and lax.top_k agree only there
    srt = np.sort(probs.numpy(), axis=-1)[:, ::-1]
    assert np.min(srt[:, :cfg.top_k] - srt[:, 1:cfg.top_k + 1]) > TIE_GAP
    C = moe._capacity(x2.shape[0], cfg)
    pos, keep = moe._slots(cfg, top_i, C)
    assert C == int(ref[f"{tag}/capacity"])
    np.testing.assert_array_equal(top_i.numpy(), ref[f"{tag}/top_i"])
    np.testing.assert_array_equal(pos.numpy(), ref[f"{tag}/pos"])
    np.testing.assert_array_equal(keep.numpy(), ref[f"{tag}/keep"])
    assert np.max(np.abs(top_w.numpy() - ref[f"{tag}/top_w"])) <= TOL
    if case == "drops":          # C = 8 slots for ~12 choices an expert
        assert int((~keep).sum()) >= 16


@pytest.mark.parametrize("case", CASES)
def test_moe_apply_and_aux_loss_match_reference(ref, case):
    cfg, tag = _cfg(case), f"moe/{case}"
    p = _moe_params(ref, case)
    assert ("shared" in p) == bool(cfg.n_shared_experts)
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(X[case]))
    assert y.shape == X_SHAPE and aux.dtype == torch.float32
    assert np.max(np.abs(y.numpy() - ref[f"{tag}/y"])) <= TOL
    np.testing.assert_allclose(float(aux), float(ref[f"{tag}/aux"]),
                               rtol=TOL)


def test_full_size_active_parameter_count():
    cfg = get_config(ARCH)
    assert cfg.n_active_params() == FULL_ACTIVE
    assert cfg.n_active_params() < cfg.n_params()
    dense = get_config("llama3_2_3b")
    assert dense.n_active_params() == dense.n_params()


@pytest.mark.parametrize("trace", TRACES)
def test_engine_tokens_and_spread_match_reference(ref, trace):
    params = params_from_jax(unflatten(ref, "engine/params/"), CFG, "cpu")
    tr = TRACES[trace]
    reqs = synthetic_trace(tr["n"], CFG.vocab,
                           prompt_lens=tuple(tr["prompt_lens"]),
                           new_tokens=tuple(tr["new_tokens"]),
                           mean_gap=tr["mean_gap"], seed=tr["seed"])
    eng = Engine(CFG, params, EngineConfig(
        layout=PagedLayout(**ENGINE_LAYOUT), kv_bits=tr["kv_bits"]),
        device="cpu")
    rep = eng.run(reqs)
    for r in reqs:
        assert rep.tokens[r.rid] == ref[f"engine/{trace}/tokens/{r.rid}"
                                        ].tolist(), r.rid
        assert len(rep.tokens[r.rid]) == r.max_new
    assert rep.format_spread == json.loads(str(ref[f"engine/{trace}/spread"]))


def test_lm_steps_match_reference(ref):
    cfg = dataclasses.replace(CFG, remat="full")
    params = params_from_jax(unflatten(ref, "lm/params/"), cfg, "cpu",
                             training=True)
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(cfg.family).loss_fn(cfg), opt,
                                  qcfg)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=LM["seq"],
                                         global_batch=LM["batch"], seed=0))
    hist = {k: [] for k in FMTS + ("loss", "aux_loss")}
    for i in range(LM["steps"]):
        state, m = step(state, data.batch(i))
        for k in hist:
            hist[k].append(float(m[k]))
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"lm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref["lm/hist/loss"],
                               rtol=LOSS_RTOL)
    # the load-balance loss of 2 layers, each near top_k = 2 when balanced
    assert all(np.isfinite(hist["aux_loss"])) and min(hist["aux_loss"]) > 0


def test_router_stays_fp32():
    full = get_config(ARCH)
    defs = transformer.model_defs(full)
    assert defs["layers"]["moe"]["router"].dtype == torch.float32
    assert defs["layers"]["moe"]["w_in"].dtype == torch.bfloat16
    assert defs["layers"]["moe"]["w_in"].shape == (48, 128, 2048, 768)
    # the compute cast of a training block leaves it (and the norms) fp32
    kept = kept_f32(transformer.layer_defs,
                    dataclasses.replace(CFG, dtype="bfloat16"))
    assert kept["moe"]["router"] and kept["norm1"]
    assert not kept["moe"]["w_in"] and not kept["attn"]["wq"]
    # and so does the conversion at a bf16 working dtype, 4-D leaves whole
    cfg16 = dataclasses.replace(CFG, dtype="bfloat16")
    params = init_params(transformer.model_defs(cfg16), "cpu",
                         torch.Generator().manual_seed(0))
    np_tree = tree_lib.map_tree(lambda t: t.float().numpy(), params)
    back = params_from_jax(np_tree, cfg16, "cpu")
    assert back["layers"]["moe"]["router"].dtype == torch.float32
    assert back["layers"]["moe"]["w_out"].dtype == torch.bfloat16
    assert back["layers"]["moe"]["w_out"].shape == (
        CFG.n_layers, CFG.n_experts, CFG.moe_d_ff, CFG.d_model)
    assert torch.equal(back["layers"]["moe"]["router"],
                       params["layers"]["moe"]["router"])


def test_aux_loss_leaves_a_checkpointed_block_once(one_thread):
    """The block returns its load-balance loss as a value: under full and
    dots remat the recompute does not count it again, so the loss, the
    reported aux loss and the gradients equal the run without remat."""
    params = init_params(transformer.model_defs(CFG, torch.float32), "cpu",
                         torch.Generator().manual_seed(1))
    batch = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=12,
                                          global_batch=2)).batch(0)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(CFG, remat=remat)
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree_lib.leaves(params)]
        loss, aux = transformer.loss_fn(cfg)(
            tree_lib.from_leaves(params, leaves), batch)
        out[remat] = (loss, aux["aux_loss"], torch.autograd.grad(loss, leaves))
    l0, a0, g0 = out["none"]
    assert float(a0) > 0
    for remat in ("full", "dots"):
        l1, a1, g1 = out[remat]
        assert torch.equal(l0, l1) and torch.equal(a0, a1), remat
        for a, b in zip(g0, g1):
            assert torch.equal(a, b), remat
