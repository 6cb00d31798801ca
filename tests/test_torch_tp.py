"""The sharded train step: a smoke state placed over a (data × model) mesh,
FSDP over data and tensor parallelism over model, each rank on its blocks,
against the JAX package's own sharded step.

* Smoke llama3.2-3b, 3 SGD steps at nearest rounding, on stacked (2, 4)
  and (1, 4) meshes and over a gloo ``DeviceMesh`` of 8 processes at
  (2, 4): the loss within ``rtol=2e-4`` of the reference's step jitted
  with ``in_shardings`` on its own (2, 4) mesh at each step (job
  ``sharded_step``, the reference's ``test_sharded_train_step_matches_
  single_device``), and ⟨IL, FL⟩ of every domain equal to the port's
  unsharded step's; the parameters within ``PARAM_DIFF_STEPS`` weight-grid
  steps of the unsharded step's, and of the reference's sharded step's.
* The three layouts of attention (``_constrain_qkv``): heads on the model
  axis, the half-head case of the smoke config (KV = 2 at model = 4: a
  rank's columns of ``wk``/``wv`` cut a KV head, so K/V are gathered), the
  query sequence on the model axis (heads the axis does not divide) and
  ``batch2d``: output and gradients against the whole layer.
* qwen3-moe at smoke size: the placed step at (2, 4) against the
  reference's step on the all-to-all (job ``ep_train``), and over a gloo
  (1, 4) ``DeviceMesh`` equal to the stacked run bit for bit (its MoE
  layer on the all-to-all over the process group).
* gemma, mistral and nemotron at smoke size through the same block body,
  against the port's unsharded step; whisper, deepseek-v2, mamba2 and
  internvl2, and llama with attention biases or a vision prefix, the same
  way.
* The int8 wire and ZeRO-1 with a model axis warn and fall back to the
  placed step, as the reference's do (job ``sharded_step`` with the flags).
  ``train.main(..., mesh=...)`` prints the bytes each rank holds.
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (LogicalRules, StackedMesh, axis_rules,
                                       gather_placed, place_tensor, relayout)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import attention, moe, registry
from repro_torch.models.common import init_params
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

STEPS, SEQ, BATCH = 3, 16, 8
EP = {"steps": 3, "seq": 16, "batch": 8}
LOSS_RTOL = 2e-4                # the reference's own sharded-step bound
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
GUARD_KEYS = ("health", "skipped", "trips", "degraded")
# nearest rounding on a grid of 2^-FL: a sum taken in another order can
# land a value on the neighbouring grid point, and the step after moves it
PARAM_DIFF_STEPS = 4
ATTN_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return run_reference(
        [{"job": "sharded_step", "tag": "ll",
          "kw": {"steps": STEPS, "seq": SEQ, "batch": BATCH,
                 "mesh": [2, 4]}},
         {"job": "ep_train", "tag": "qw",
          "kw": {**EP, "arch": "qwen3_moe_30b_a3b", "mesh": [2, 4]}},
         {"job": "sharded_step", "tag": "fb",
          "kw": {"steps": STEPS, "seq": SEQ, "batch": BATCH, "mesh": [2, 4],
                 "grad_allreduce_bits": 8, "zero_opt_shards": 2,
                 "whole": False}}],
        host_devices=8)


def _cfg(arch="llama3_2_3b"):
    return dataclasses.replace(smoke(get_config(arch)), remat="full")


def _run(cfg, mesh, params=None, steps=STEPS, qcfg=None, opt_cfg=None,
         seq=SEQ, extras=None, faults=None):
    """``steps`` steps (SGD at nearest rounding unless ``qcfg`` and
    ``opt_cfg`` say otherwise) from ``params`` (the port's seed-0 draw if
    None), placed over ``mesh`` when given; ``extras`` (a VLM's
    ``vision_embeds``, an encoder-decoder's ``frames``) ride on every
    batch; ``faults`` (a ``FaultPlan``) goes into the step.  Returns the
    history (with the guards' ``GUARD_KEYS`` when ``qcfg.guards``) and the
    whole final parameters."""
    mod = registry(cfg.family)
    if params is None:
        params = init_params(mod.model_defs(cfg, cfg.master_dtype()), "cpu",
                             torch.Generator().manual_seed(0))
    qcfg = qcfg or qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(opt_cfg or SGDConfig())
    step = specs.build_train_step(cfg, qcfg, opt, accum_steps=1, mesh=mesh,
                                  faults=faults)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    if mesh is not None:
        assert step.placed
        specs.place_train_state(cfg, state, mesh)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=BATCH, seed=0))
    hist = {k: [] for k in FMTS + ("loss",)
            + (GUARD_KEYS if qcfg.guards is not None else ())}
    for i in range(steps):
        state, m = step(state, dict(data.batch(i), **(extras or {})))
        for k in hist:
            hist[k].append(float(m[k]))
    final = gather_placed(state.params) if mesh is not None else state.params
    return hist, final


def _ref_params(ref, cfg, key):
    return params_from_jax(unflatten(ref, key), cfg, "cpu", training=True)


def _close_params(a, b, fl):
    grid = 2.0 ** -fl
    for (k, x), (_, y) in zip(tree_lib.leaves_with_path(a),
                              tree_lib.leaves_with_path(b)):
        assert float(torch.max(torch.abs(x - y))) <= PARAM_DIFF_STEPS * grid, k


def _check_against(hist, want_hist, want_fmts=None):
    np.testing.assert_allclose(hist["loss"], want_hist["loss"],
                               rtol=LOSS_RTOL)
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k]),
                                      np.asarray((want_fmts or want_hist)[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def unsharded(ref):
    cfg = _cfg()
    return _run(cfg, None, _ref_params(ref, cfg, "ll/params/"))


@pytest.mark.parametrize("shape", [(2, 4), (1, 4)])
def test_placed_step_matches_reference_sharded_step(ref, unsharded, shape):
    cfg = _cfg()
    hist, final = _run(cfg, StackedMesh(shape, ("data", "model")),
                       _ref_params(ref, cfg, "ll/params/"))
    want = {k: list(ref[f"ll/sharded/hist/{k}"]) for k in hist}
    _check_against(hist, want, unsharded[0])
    _close_params(final, unsharded[1], hist["fl_w"][-1])
    _close_params(final, _ref_params(ref, cfg, "ll/sharded/final/"),
                  hist["fl_w"][-1])
    # the reference's own sharded step agrees with its unsharded one
    np.testing.assert_allclose(ref["ll/sharded/hist/loss"],
                               ref["ll/whole/hist/loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", ["k1b", "k1_operand", "adamw"])
def test_placed_step_matches_unsharded_step(case, one_thread):
    """Stochastic rounding with the in-kernel stream (block mode) and with
    the bits operand (the whole leaf's draw, sliced), and AdamW with its
    global-norm clip summed over every rank's blocks: at (2, 4) the
    unsharded step's formats, its losses within ``LOSS_RTOL``."""
    cfg = _cfg()
    kw = {"k1b": dict(qcfg=qtrain.QuantConfig()),
          "k1_operand": dict(qcfg=qtrain.QuantConfig(onchip_prng=False)),
          "adamw": dict(opt_cfg=AdamWConfig(warmup=1))}[case]
    want, _ = _run(cfg, None, **kw)
    got, _ = _run(cfg, StackedMesh((2, 4), ("data", "model")), **kw)
    _check_against(got, want)


def test_placed_step_with_the_residual_replicated_over_model(one_thread):
    """At sequence 18 the model axis of 4 does not divide the sequence, so
    the residual stream stays replicated over it (the rules' fallback):
    each rank's tap quantizes the whole cotangent (summed over the axis)
    and hands back its share.  Stochastic rounding: the unsharded step's
    formats, its losses within ``LOSS_RTOL``."""
    cfg = _cfg()
    q = qtrain.QuantConfig()
    want, _ = _run(cfg, None, qcfg=q, seq=18)
    got, _ = _run(cfg, StackedMesh((2, 4), ("data", "model")), qcfg=q,
                  seq=18)
    _check_against(got, want)


def test_one_update_parts_from_the_unsharded_one_by_grid_flips(one_thread):
    """Why the later losses part while the first agrees: after one K1b
    step at (2, 4) (fp32, smoke widened to D 256) the parameters equal the
    unsharded step's but where a sum in another order tipped a rounding
    onto the neighbouring grid point — a share under 1e-3, each one
    weight-grid step at most at this depth (a tipped activation or
    cotangent feeds the next layer, so at full depth the parts grow:
    ``chip_smoke.py``'s ``train_llama_tp`` bounds them there)."""
    cfg = dataclasses.replace(_cfg(), d_model=256, d_ff=512, vocab=1024)
    q = qtrain.QuantConfig()
    want, whole = _run(cfg, None, steps=1, qcfg=q, seq=64)
    got, placed = _run(cfg, StackedMesh((2, 4), ("data", "model")), steps=1,
                       qcfg=q, seq=64)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    grid = 2.0 ** -want["fl_w"][0]
    n = differ = 0
    for (k, x), (_, y) in zip(tree_lib.leaves_with_path(whole),
                              tree_lib.leaves_with_path(placed)):
        d = torch.abs(x - y)
        n += d.numel()
        differ += int(torch.count_nonzero(d))
        assert float(d.max()) <= grid, k
    assert 0 < differ <= 1e-3 * n


def test_tap_on_a_replicated_block_quantizes_the_whole_cotangent():
    """A tap on a tensor replicated over the model axis: forward, every
    rank's q is the whole tap's; backward, each rank's cotangent is its
    share of the whole one, and the shares the tap hands back sum to the
    whole tap's quantized cotangent (on a grid coarse enough that
    quantizing the shares apart would not)."""
    from repro_torch.core import fixed_point as fxp
    mesh = StackedMesh((1, 4), ("data", "model"))
    g = torch.Generator().manual_seed(6)
    x = torch.randn(4, 6, 8, generator=g)
    shares = [torch.randn(4, 6, 8, generator=g) for _ in range(4)]
    qctx = qtrain.QCtx(acts_fmt=fxp.FixedPointFormat.create(4, 4),
                       grads_fmt=fxp.FixedPointFormat.create(4, 2), seed=3,
                       rounding="nearest", collect_stats=True)
    xw = x.clone().requires_grad_()
    qw, sw = qctx.tap(xw, 0)
    (gw,) = torch.autograd.grad(qw, xw, sum(shares))
    xp = qtrain._rank_leaves(place_tensor(x, (None, None, None), mesh))
    qp, sp = qctx.tap(xp, 0)
    assert all(torch.equal(b, qw.detach()) for b in qp.blocks)
    assert torch.equal(sp.count, sw.count)
    grads = torch.autograd.grad(qp.blocks, xp.blocks, shares)
    assert torch.equal(((grads[0] + grads[1]) + grads[2]) + grads[3], gw)


# ---------------------------------------------------------------------------
# over gloo processes
# ---------------------------------------------------------------------------

def _gloo_rank(rank, world, shape, arch, store_path, out_path, params):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        hist, final = _run(_cfg(arch), mesh, params)
        if rank == 0:
            torch.save((hist, final), out_path)
    finally:
        dist.destroy_process_group()


def _gloo_run(tmp_path, shape, arch, params):
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "out")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, world, shape, arch, str(tmp_path / "store"),
                               out, params))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return torch.load(out)


def test_gloo_8_process_step_matches_reference(ref, unsharded, one_thread,
                                               tmp_path):
    cfg = _cfg()
    hist, final = _gloo_run(tmp_path, (2, 4), "llama3_2_3b",
                            _ref_params(ref, cfg, "ll/params/"))
    want = {k: list(ref[f"ll/sharded/hist/{k}"]) for k in hist}
    _check_against(hist, want, unsharded[0])
    _close_params(final, unsharded[1], hist["fl_w"][-1])


def test_qwen_moe_placed_matches_reference_and_gloo(ref, one_thread,
                                                    tmp_path):
    cfg = _cfg("qwen3_moe_30b_a3b")
    params = _ref_params(ref, cfg, "qw/params/")
    before = dict(moe.DISPATCH_COUNTS)
    hist, final = _run(cfg, StackedMesh((2, 4), ("data", "model")),
                       tree_lib.map_tree(torch.clone, params))
    assert moe.DISPATCH_COUNTS["a2a"] > before["a2a"]
    assert moe.DISPATCH_COUNTS["einsum"] == before["einsum"]
    want = {k: list(ref[f"qw/hist/{k}"]) for k in hist}
    _check_against(hist, want)
    _close_params(final, _ref_params(ref, cfg, "qw/final/"), hist["fl_w"][-1])
    # the MoE all-to-all over a process group: the (1, 4) run over gloo is
    # the stacked (1, 4) run, bit for bit
    stacked = _run(cfg, StackedMesh((1, 4), ("data", "model")),
                   tree_lib.map_tree(torch.clone, params))
    hist_pg, final_pg = _gloo_run(tmp_path, (1, 4), "qwen3_moe_30b_a3b",
                                  params)
    assert hist_pg == stacked[0]
    for (k, a), (_, b) in zip(tree_lib.leaves_with_path(final_pg),
                              tree_lib.leaves_with_path(stacked[1])):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# attention's three layouts
# ---------------------------------------------------------------------------

def _attn_case(overrides, shape):
    cfg = dataclasses.replace(smoke(get_config("llama3_2_3b")), **overrides)
    mesh = StackedMesh(shape, ("data", "model"))
    rules = LogicalRules()
    defs = attention.gqa_defs(cfg, torch.float32)
    p = init_params(defs, "cpu", torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x = torch.randn(8, 16, cfg.d_model, generator=g)
    w = torch.randn(8, 16, cfg.d_model, generator=g)
    pos = torch.arange(16, dtype=torch.int32)[None, :]
    # whole
    pw = {k: v.clone().requires_grad_() for k, v in p.items()}
    xw = x.clone().requires_grad_()
    out, _ = attention.gqa_apply(cfg, pw, xw, positions=pos, mode="train")
    gw = torch.autograd.grad((out * w).sum(), [xw, *pw.values()])
    # placed: every element of the output on one rank, so the objective
    # is the sum of the ranks' pieces
    with axis_rules(mesh, rules):
        pp = {k: place_tensor(v, rules.spec(d.logical, d.shape, mesh), mesh)
              for (k, v), d in zip(p.items(), defs.values())}
        leaves = {k: qtrain._rank_leaves(v) for k, v in pp.items()}
        spec = rules.spec(("batch", "tp_seq", "embed"), x.shape, mesh)
        xp = place_tensor(x, spec, mesh).map(
            lambda b: b.clone().requires_grad_())
        o = attention.gqa_apply(cfg, leaves, xp, positions=pos,
                                mode="train")[0]
        o = relayout(o, spec)
        wp = place_tensor(w, spec, mesh)
        loss = [(a * b).sum() for a, b in zip(o.blocks, wp.blocks)]
        ins = xp.blocks + [b for v in leaves.values() for b in v.blocks]
        grads = torch.autograd.grad(loss, ins)
    got_out = gather_placed(o)
    torch.testing.assert_close(got_out, out.detach(), rtol=ATTN_RTOL,
                               atol=ATTN_RTOL)
    nx = len(xp.blocks)
    gx = type(xp)(list(grads[:nx]), xp.spec, mesh)
    torch.testing.assert_close(gather_placed(gx), gw[0],
                               rtol=ATTN_RTOL, atol=ATTN_RTOL)
    at = nx
    for (k, v), want in zip(leaves.items(), gw[1:]):
        gb = list(grads[at:at + len(v.blocks)])
        at += len(v.blocks)
        # a leaf replicated over an axis: each rank holds its share
        gb = sharding.psum(mesh, v.replicated_axes(), gb)
        torch.testing.assert_close(
            gather_placed(type(v)(gb, v.spec, mesh)), want, rtol=ATTN_RTOL,
            atol=ATTN_RTOL, msg=k)
    return cfg


@pytest.mark.parametrize("case", ["half_head", "heads", "tp_seq", "batch2d"])
def test_attention_layouts_match_the_whole_layer(case):
    over, shape = {
        # KV = 2 at model = 4: wk's columns cut a head in half
        "half_head": ({}, (2, 4)),
        "heads": ({"n_kv_heads": 4}, (2, 4)),
        # 6 heads on a model axis of 4: the query sequence goes on it
        "tp_seq": ({"n_heads": 6, "n_kv_heads": 2}, (1, 4)),
        "batch2d": ({"n_heads": 6, "n_kv_heads": 2, "attn_batch2d": True},
                    (2, 4)),
    }[case]
    cfg = _attn_case(over, shape)
    if case == "half_head":
        assert cfg.n_kv_heads == 2 and cfg.n_kv_heads % shape[1]


# ---------------------------------------------------------------------------
# the wire and ZeRO-1 under a model axis, and the CLI's summary
# ---------------------------------------------------------------------------

def test_wire_and_zero_refuse_a_model_axis(ref):
    """With a model axis above 1 the int8 wire and ZeRO-1 do not engage:
    the step warns with the reference's words and falls back to the placed
    step (``wire_sync_active`` and ``zero_opt_active`` False, as the
    reference's), whose 3 steps give the reference's sharded step run with
    the same flags (job ``sharded_step``): its formats, its losses within
    ``LOSS_RTOL``, and the plan's ``wire_grads``/``wire_params`` domains
    under the same ``.dps`` checkpoint keys."""
    cfg = _cfg()
    opt = make_optimizer(SGDConfig())
    mesh = StackedMesh((2, 4), ("data", "model"))
    q = qtrain.QuantConfig(rounding="nearest", grad_allreduce_bits=8,
                           zero_opt_shards=2)
    with pytest.warns(UserWarning) as caught:
        step = specs.build_train_step(cfg, q, opt, mesh=mesh)
    assert [str(w.message) for w in caught] == json.loads(
        str(ref["fb/sharded/warnings"]))
    assert step.placed and not (step.wire_sync_active
                                or step.zero_opt_active)
    assert list(ref["fb/sharded/active"]) == [False, False]
    with pytest.warns(UserWarning, match="pure data-parallel mesh"):
        hist, _ = _run(cfg, mesh, _ref_params(ref, cfg, "fb/params/"),
                       qcfg=q)
    want = {k: list(ref[f"fb/sharded/hist/{k}"]) for k in hist}
    _check_against(hist, want)
    keys = {k: [list(v.shape), str(v.dtype)]
            for k, v in qtrain.dps_restore_defaults(q).items()}
    assert keys == json.loads(str(ref["fb/sharded/dps_keys"]))
    assert ".dps/wire_params/.il" in keys
    # the optimizer state stays per leaf, placed like the parameters, as
    # the reference's train_state_shardings places it without ZeRO-1
    assert specs.train_state_shardings(cfg, mesh, LogicalRules(), opt,
                                       q).opt_state == {
        "mu": specs.param_shardings(cfg, mesh, LogicalRules())}
    # on a pure data mesh they keep their data-parallel step, which the
    # placed step does not run
    step = specs.build_train_step(cfg, qtrain.QuantConfig(
        grad_allreduce_bits=8), opt, mesh=StackedMesh((2,), ("data",)))
    assert step.wire_sync_active and not getattr(step, "placed", False)
    with pytest.raises(ValueError, match="pure data-parallel mesh"):
        qtrain.make_placed_train_step(
            registry("dense").placed_loss_fn(cfg), opt,
            qtrain.QuantConfig(grad_allreduce_bits=8),
            StackedMesh((2,), ("data",)), LogicalRules())


def _batch_extras(cfg):
    """A VLM's ``vision_embeds`` or an encoder-decoder's ``frames`` for
    every batch, drawn from a seed."""
    g = torch.Generator().manual_seed(7)
    if cfg.n_patches:
        return {"vision_embeds": torch.randn(BATCH, cfg.n_patches,
                                             cfg.d_model, generator=g)}
    if cfg.family == "encdec":
        return {"frames": torch.randn(BATCH, cfg.enc_seq, cfg.d_model,
                                      generator=g)}
    return {}


def _placed_matches_unsharded(cfg, shape):
    """3 SGD steps at nearest placed over ``shape`` against the port's
    unsharded step: its formats, its losses within ``LOSS_RTOL`` and its
    parameters within ``PARAM_DIFF_STEPS`` weight-grid steps.  A MoE
    model's unsharded step runs under the mesh's binding, so that both
    take the all-to-all dispatch (each rank's capacity)."""
    extras = _batch_extras(cfg)
    mesh = StackedMesh(shape, ("data", "model"))
    with (axis_rules(mesh, LogicalRules()) if cfg.n_experts
          else contextlib.nullcontext()):
        want, want_final = _run(cfg, None, extras=extras)
    got, final = _run(cfg, mesh, extras=extras)
    _check_against(got, want)
    _close_params(final, want_final, got["fl_w"][-1])


@pytest.mark.parametrize("arch", ["whisper_medium", "deepseek_v2_236b",
                                  "mamba2_1_3b", "internvl2_26b"])
def test_family_runs_placed_like_the_unsharded_step(arch, one_thread):
    """Each family that had no placed step before builds and runs it at
    (1, 4) as the unsharded step runs (``tests/test_torch_tp_families.py``
    holds them to the reference's sharded step)."""
    _placed_matches_unsharded(_cfg(arch), (1, 4))


@pytest.mark.parametrize("overrides", [{"attn_bias": True},
                                       {"n_patches": 4}])
def test_a_layer_feature_runs_placed_like_the_unsharded_step(overrides,
                                                             one_thread):
    """A llama-shaped config with attention biases, or with a vision
    prefix, at (2, 4) as its unsharded step runs it."""
    _placed_matches_unsharded(dataclasses.replace(_cfg(), **overrides),
                              (2, 4))


# the dense layers' other features, each through the one block body:
# gemma (MHA, GeGLU), mistral (GQA at the half-head split, untied
# unembedding), nemotron (squared ReLU, no gate, untied)
@pytest.mark.parametrize("arch", ["gemma_7b", "mistral_large_123b",
                                  "nemotron_4_340b"])
def test_dense_variants_run_placed(arch, one_thread):
    """Each at (2, 4), 3 SGD steps at nearest: the unsharded step's
    formats, its losses within ``LOSS_RTOL`` and its parameters within
    ``PARAM_DIFF_STEPS`` weight-grid steps."""
    cfg = _cfg(arch)
    want, want_final = _run(cfg, None)
    got, final = _run(cfg, StackedMesh((2, 4), ("data", "model")))
    _check_against(got, want)
    _close_params(final, want_final, got["fl_w"][-1])


def test_train_main_on_a_mesh_prints_held_bytes(capsys, tmp_path):
    from repro_torch.launch import train as train_cli
    out = train_cli.main(
        ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu", "--steps",
         "2", "--batch", "8", "--seq", "16", "--optimizer", "sgd",
         "--ckpt-dir",
         str(tmp_path / "ck")], cfg=_cfg(),
        mesh=mesh_lib.make_mesh((2, 4), ("data", "model")))
    cfg = _cfg()
    mesh = StackedMesh((2, 4), ("data", "model"))
    from repro_torch.dist.sharding import spec_bytes
    from repro_torch.models.common import abstract_params
    aparams = abstract_params(registry(cfg.family).model_defs(
        cfg, cfg.master_dtype()))
    per_rank = 2 * spec_bytes(aparams, specs.param_shardings(
        cfg, mesh, LogicalRules()), mesh)
    assert out["held_bytes_per_rank"] == [per_rank] * 8
    assert out["mesh"] == {"data": 2, "model": 4}
    assert '"held_bytes_per_rank"' in capsys.readouterr().out
    assert os.path.isdir(tmp_path / "ck" / "step_00000002")
