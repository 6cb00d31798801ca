"""Every remaining family on the sharded train step: MLA (deepseek-v2),
the vision prefix (internvl2), Mamba2 and the hybrid (mamba2, zamba2) and
the encoder-decoder with attention biases (whisper), each at smoke size
placed over a (data × model) mesh against the JAX package's own sharded
step.

* Each family, 3 SGD steps at nearest rounding from the reference's
  parameters, on stacked (1, 4) and (2, 4) meshes: ⟨IL, FL⟩ of every
  domain equal to the reference's step jitted with ``in_shardings`` on its
  (2, 4) mesh (job ``sharded_step``, the VLM's ``vision_embeds`` and the
  encoder-decoder's ``frames`` drawn from a numpy seed and placed over
  ``batch``) at every step, the loss within ``LOSS_RTOL``, the parameters
  within ``PARAM_DIFF_STEPS`` weight-grid steps of its final ones.
  deepseek-v2's MoE layers take the all-to-all there (each rank's
  capacity), in both packages, so its sharded losses part from its
  unsharded ones and depend on the split: each mesh is held to the
  reference's step on the same mesh.
* Every config at full size builds the placed step on a (2, 4) mesh,
  guarded and with a fault plan, and under ZeRO-1 (which falls back).
* Each new placed form against its whole layer, forward and gradient, in
  fp32, on a mesh that splits its leaves over ``model``: MLA, the biased
  MHA (causal and not), cross-attention, the Mamba2 mixer (heads split,
  and heads the axis does not divide), the hybrid's shared block applied
  twice, and the vision-prefix embedding.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_NAMES, get_config, smoke
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (LogicalRules, StackedMesh, axis_rules,
                                       gather_placed, place_tensor, relayout,
                                       spec_axes)
from repro_torch.launch import specs
from repro_torch.models import attention, hybrid, ssm, transformer
from repro_torch.models.common import init_params, map_defs
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.resilience import FaultPlan, GuardConfig
from test_torch_jaxref import run_reference
from test_torch_tp import (BATCH, FMTS, LOSS_RTOL, SEQ, STEPS, _cfg,
                           _close_params, _ref_params, _run)

ARCHS = ("deepseek_v2_236b", "internvl2_26b", "mamba2_1_3b", "zamba2_7b",
         "whisper_medium")
MESHES = [(1, 4), (2, 4)]
REF_MESH = (2, 4)
LAYER_RTOL = 1e-5


def _extras(arch):
    """The batch's non-token inputs, drawn from a numpy seed."""
    cfg = smoke(get_config(arch))
    g = np.random.default_rng(11)
    if cfg.family == "vlm":
        return {"vision_embeds": g.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": g.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {}


def _ref_mesh(arch, shape):
    """The reference mesh a placed run at ``shape`` is held to: (2, 4),
    but a MoE model's own shape (the all-to-all's capacity is each rank's,
    so the dropped choices depend on the split)."""
    return tuple(shape) if smoke(get_config(arch)).n_experts else REF_MESH


def _tag(arch, mesh):
    return f"{arch}_{mesh[0]}x{mesh[1]}"


def _ref_job(job):
    arch, mesh = job
    tag = _tag(arch, mesh)
    return run_reference(
        [{"job": "sharded_step", "tag": tag,
          "kw": {"steps": STEPS, "seq": SEQ, "batch": BATCH,
                 "mesh": list(mesh), "arch": arch}}],
        {f"{tag}/{k}": v for k, v in _extras(arch).items()},
        host_devices=8)


@pytest.fixture(scope="module")
def ref():
    jobs = sorted({(a, _ref_mesh(a, s)) for a in ARCHS for s in MESHES})
    # one child a job, run side by side
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        outs = list(pool.map(_ref_job, jobs))
    return {k: v for o in outs for k, v in o.items()}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_placed_step_matches_reference_sharded_step(ref, arch, shape):
    cfg = _cfg(arch)
    tag = _tag(arch, _ref_mesh(arch, shape))
    extras = {k: torch.from_numpy(v) for k, v in _extras(arch).items()}
    mesh = StackedMesh(shape, ("data", "model"))
    # the mesh splits the family's layer leaves over model
    split = [k for k, s in tree_lib.leaves_with_path(
        specs.param_shardings(cfg, mesh, LogicalRules()))
             if "model" in spec_axes(s) and k[0] != "embed"]
    assert len(split) >= 4, split
    hist, final = _run(cfg, mesh, _ref_params(ref, cfg, f"{tag}/params/"),
                       extras=extras)
    want = {k: list(ref[f"{tag}/sharded/hist/{k}"]) for k in hist}
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=LOSS_RTOL)
    for k in FMTS:
        np.testing.assert_array_equal(hist[k], want[k], err_msg=k)
    _close_params(final, _ref_params(ref, cfg, f"{tag}/sharded/final/"),
                  hist["fl_w"][-1])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_config_builds_the_placed_step(arch):
    """At full size on a (2, 4) mesh every config's step is the placed one
    (nothing is drawn: the step is built, not run), guarded and with a
    fault plan too; ZeRO-1 warns and falls back to it, as the reference's
    step does; the wire flip, which needs the int8 wire's payload, still
    raises."""
    cfg = get_config(arch)
    opt = make_optimizer(SGDConfig())
    mesh = StackedMesh((2, 4), ("data", "model"))
    assert specs.build_train_step(cfg, qtrain.QuantConfig(), opt,
                                  mesh=mesh).placed
    step = specs.build_train_step(
        cfg, qtrain.QuantConfig(guards=GuardConfig()), opt, mesh=mesh,
        faults=FaultPlan(nan_grads_at=1))
    assert step.placed and step.guards_active
    with pytest.warns(UserWarning, match="pure data-parallel mesh"):
        step = specs.build_train_step(
            cfg, qtrain.QuantConfig(zero_opt_shards=2), opt, mesh=mesh)
    assert step.placed and not step.zero_opt_active
    with pytest.raises(ValueError, match="wire_flip_at"):
        specs.build_train_step(cfg, qtrain.QuantConfig(), opt, mesh=mesh,
                               faults=FaultPlan(wire_flip_at=1))


# ---------------------------------------------------------------------------
# each new placed form against its whole layer
# ---------------------------------------------------------------------------

def _layer_check(defs, fn, inputs, in_logical, out_logical, mesh, *,
                 split, seed=1, perturb=()):
    """``fn(params, *inputs)`` whole and placed over ``mesh`` (parameters
    by their declarations' specs, input ``i`` by ``in_logical[i]``, the
    output laid out by ``out_logical`` so that each element lies on one
    rank): the output and the gradients of ``sum(out * w)`` for every
    input and every parameter within ``LAYER_RTOL`` (:func:`_close`).  ``split``: the
    parameter paths the mesh must split over ``model``; ``perturb``: the
    paths drawn at random in place of their zero init (biases)."""
    rules = LogicalRules()
    p = init_params(defs, "cpu", torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for path in perturb:
        node = p
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = 0.1 * torch.randn(node[path[-1]].shape, generator=g)
    logical = map_defs(lambda d: d.logical, defs)
    pspecs = tree_lib.map_tree(lambda l, t: rules.spec(l, t.shape, mesh),
                               logical, p)
    for path in split:
        node = pspecs
        for k in path:
            node = node[k]
        assert "model" in spec_axes(node), (path, node)
    # whole
    pw = tree_lib.map_tree(lambda t: t.clone().requires_grad_(), p)
    xw = [x.clone().requires_grad_() if x.is_floating_point() else x
          for x in inputs]
    out = fn(pw, *xw)
    w = torch.randn(out.shape, generator=g)
    diff = [x for x in xw if x.requires_grad] + tree_lib.leaves(pw)
    gw = torch.autograd.grad((out * w).sum(), diff, allow_unused=True,
                             materialize_grads=True)
    # placed
    with axis_rules(mesh, rules):
        leaves = tree_lib.map_tree(
            lambda t, s: qtrain._rank_leaves(place_tensor(t, s, mesh)), p,
            pspecs)
        xp = []
        for x, lg in zip(inputs, in_logical):
            t = place_tensor(x, rules.spec(lg, x.shape, mesh), mesh)
            # one autograd leaf a rank, replicated ranks too
            xp.append(qtrain._rank_leaves(t) if x.is_floating_point() else t)
        o = fn(leaves, *xp)
        ospec = rules.spec(out_logical, out.shape, mesh)
        o = relayout(o, ospec)
        wp = place_tensor(w, ospec, mesh)
        loss = [(a * b).sum() for a, b in zip(o.blocks, wp.blocks)]
        dp = [x for x in xp if x.dtype.is_floating_point] + \
            tree_lib.leaves(leaves)
        grads = torch.autograd.grad(loss, [b for t in dp for b in t.blocks],
                                    allow_unused=True, materialize_grads=True)
    _close(gather_placed(o), out.detach(), "out")
    paths = tree_lib.leaves_with_path(leaves)
    names = [f"input {i}" for i in range(len(dp) - len(paths))]
    names += ["/".join(k) for k, _ in paths]
    largest = max(float(t.abs().max()) for t in gw)
    at = 0
    for name, t, want in zip(names, dp, gw):
        gb = list(grads[at:at + len(t.blocks)])
        at += len(t.blocks)
        # a tensor replicated over an axis: each rank holds its share
        gb = sharding.psum(mesh, t.replicated_axes(), gb)
        got = gather_placed(sharding.Placed(gb, t.spec, mesh, t.shape))
        if name.endswith("bk"):
            # zero in exact arithmetic (a shift of every key moves a
            # query's scores alike): rounding noise in both runs
            assert max(float(got.abs().max()), float(want.abs().max())) \
                <= LAYER_RTOL * largest, name
        else:
            _close(got, want, name)


def _close(got, want, what):
    """max |got - want| within ``LAYER_RTOL`` of max |want| (the placed
    sums run in another order; an element where they cancel moves by more
    than its own relative error)."""
    assert got.shape == want.shape, what
    err = float((got - want).abs().max())
    assert err <= LAYER_RTOL * float(want.abs().max()), (what, err)


RESIDUAL = ("batch", "tp_seq", "embed")


def _x(shape, seed=3):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _pos(S):
    return torch.arange(S, dtype=torch.int32)[None, :]


@pytest.mark.parametrize("shape", MESHES)
def test_mla_layer_placed_matches_whole(shape):
    cfg = smoke(get_config("deepseek_v2_236b"))
    _layer_check(
        attention.mla_defs(cfg, torch.float32),
        lambda p, x: attention.mla_apply(cfg, p, x, positions=_pos(16),
                                         mode="train")[0],
        [_x((8, 16, cfg.d_model))], [RESIDUAL], RESIDUAL,
        StackedMesh(shape, ("data", "model")),
        split=[("wq_b",), ("w_uk",), ("w_uv",), ("wo",)])


BIASES = [("bq",), ("bk",), ("bv",), ("bo",)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", MESHES)
def test_biased_attention_placed_matches_whole(shape, causal):
    """whisper's MHA with its four biases (random, not their zero init):
    ``bq``/``bk``/``bv`` each rank's block after its column-parallel
    product, ``bo`` once after the row-parallel sum; causal (the decoder)
    and not (the encoder)."""
    cfg = smoke(get_config("whisper_medium"))
    _layer_check(
        attention.gqa_defs(cfg, torch.float32),
        lambda p, x: attention.gqa_apply(cfg, p, x, positions=_pos(16),
                                         mode="train", causal=causal)[0],
        [_x((8, 16, cfg.d_model))], [RESIDUAL], RESIDUAL,
        StackedMesh(shape, ("data", "model")),
        split=[("wq",), ("bq",), ("bk",), ("wo",)], perturb=BIASES)


@pytest.mark.parametrize("shape", MESHES)
def test_cross_attention_placed_matches_whole(shape):
    """The decoder's cross-attention: K/V from the encoder's output (12
    frames, whole on every model rank as the encoder keeps it) for 16
    queries split over the sequence."""
    cfg = smoke(get_config("whisper_medium"))
    _layer_check(
        attention.gqa_defs(cfg, torch.float32),
        lambda p, x, enc: attention.gqa_apply(
            cfg, p, x, positions=_pos(16), mode="train", kv_x=enc,
            causal=False)[0],
        [_x((8, 16, cfg.d_model)), _x((8, 12, cfg.d_model), seed=4)],
        [RESIDUAL, ("batch", "seq", "embed")], RESIDUAL,
        StackedMesh(shape, ("data", "model")),
        split=[("wk",), ("wv",), ("bv",)], perturb=BIASES)


@pytest.mark.parametrize("case", ["heads", "heads_replicated"])
@pytest.mark.parametrize("shape", MESHES)
def test_mamba2_mixer_placed_matches_whole(shape, case):
    """The Mamba2 mixer in train mode: ``w_in``'s 296 columns in blocks of
    74 across z | x | B | C | dt = 128 | 128 | 16 | 16 | 8, re-cut by
    heads (8 heads over 4 ranks); with 64-wide heads (2 heads) the model
    axis does not divide them and the scan runs whole on every rank while
    ``conv_w``, ``norm_scale`` and ``w_out`` stay split."""
    cfg = smoke(get_config("mamba2_1_3b"))
    if case == "heads_replicated":
        cfg = dataclasses.replace(cfg, ssm_head_dim=64)
    mesh = StackedMesh(shape, ("data", "model"))
    if case == "heads":
        assert ssm.n_ssm_heads(cfg) % 4 == 0
        w_in = 2 * ssm.d_inner(cfg) + 2 * cfg.ssm_state + ssm.n_ssm_heads(cfg)
        assert (w_in // 4) % cfg.ssm_head_dim
    # with the heads undivided, w_in's 2·di + 2·N + H columns do not
    # divide either (H is then odd or 2 mod 4): it stays whole
    split = [("conv_w",), ("conv_b",), ("norm_scale",), ("w_out",)]
    _layer_check(
        ssm.ssm_defs(cfg, torch.float32),
        lambda p, x: ssm.ssm_apply(cfg, p, x, mode="train")[0],
        [_x((8, 16, cfg.d_model))], [RESIDUAL], RESIDUAL, mesh,
        split=split + ([("w_in",)] if case == "heads" else []),
        perturb=[("a_log",), ("dt_bias",)])


@pytest.mark.parametrize("shape", MESHES)
def test_hybrid_shared_block_placed_matches_whole(shape):
    """zamba2's shared transformer block applied twice to the residual
    (two invocations, one parameter set): its gradient the sum over
    both."""
    cfg = smoke(get_config("zamba2_7b"))
    defs = hybrid.model_defs(cfg, torch.float32)["shared"]

    def twice(p, x):
        for g in range(2):
            x, _, _ = transformer._train_block(cfg, p, x, _pos(16), None,
                                               hybrid.SHARED_TAP_BASE + g)
        return x

    _layer_check(defs, twice, [_x((8, 16, cfg.d_model))], [RESIDUAL],
                 RESIDUAL, StackedMesh(shape, ("data", "model")),
                 split=[("attn", "wq"), ("attn", "wo"), ("mlp", "w_in"),
                        ("mlp", "w_out")])


@pytest.mark.parametrize("shape", MESHES)
def test_vision_prefix_embed_placed_matches_whole(shape):
    """internvl2's embedding: 4 patch embeddings prepended to 12 tokens'
    (vocab-parallel rows), the 16 positions then split over the model
    axis, each rank's block the whole (B, P + T, D)'s."""
    cfg = smoke(get_config("internvl2_26b"))
    defs = transformer.model_defs(cfg, torch.float32)
    defs = {"embed": defs["embed"]}
    tokens = torch.randint(0, cfg.vocab, (8, 12),
                           generator=torch.Generator().manual_seed(5))
    _layer_check(
        defs,
        lambda p, tok, vis: transformer._embed(cfg, p, tok, vis),
        [tokens, _x((8, cfg.n_patches, cfg.d_model))],
        [("batch", None), ("batch", None, None)], RESIDUAL,
        StackedMesh(shape, ("data", "model")), split=[("embed", "tok")])
