"""The MoE layer's expert-parallel all-to-all dispatch in the port against
the JAX package's, from the same weights and numpy inputs.

* ``moe_apply`` under ``axis_rules`` of a (2, 4) and a (1, 4) (data,
  model) mesh — the reference's on 8 forced CPU devices with Auto axes
  (job ``moe_a2a``), the port's on a stacked mesh — for smoke qwen3-moe and
  smoke deepseek-v2 (one shared expert), at ``capacity_factor`` 8 (no
  drops) and 1.25 (the configs' own: choices dropped), with the 16-bit and
  the int8 (``moe_a2a_bits=8``) payload: the output, the aux loss and the
  gradients of ``sum(out * w) + aux`` with respect to x, the router, the
  experts and the shared expert, in fp32 within ``TOL`` (the reference's
  own a2a-against-einsum test holds 2e-5 abs and 1e-5 relative).  Under
  int8 an element of the return leg whose product lies within an ulp of a
  half grid step may round to the other side in one framework: such
  elements move by one grid step (1/16, times the routing weight) and are
  counted.  The expert weights' gradient is zero in both packages under
  int8: the int8 cast cuts autograd (a fault of the reference, kept).
* ``_a2a_pack`` bit-equal to the reference's, ties (``x·16 = k + ½``)
  included, fp32 and bf16.
* The gate: the einsum dispatch where the model axis does not divide S or
  E, or the data axis B, bit-equal to the unbound call.
* The body over 4 gloo processes on the model axis of a (1, 4)
  ``DeviceMesh``, bit-equal to the stacked body: outputs, aux loss, and the
  gradients of x and the expert shards (the router's, a sum over ranks
  accumulated in another order, to ``ROUTER_GRAD_RTOL`` of its largest
  magnitude).
* A smoke qwen3-moe SGD step (nearest rounding) under the stacked (2, 4)
  mesh against the reference's step jitted on its (2, 4) mesh (job
  ``ep_train``): formats equal, loss to ``LOSS_RTOL``, the updated
  parameters within ``PARAM_DIFF_STEPS`` weight-grid steps, few of them
  off at all (``PARAM_DIFF_FRACTION``).
"""

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.dist.sharding import (LogicalRules, StackedMesh, axis_rules,
                                       held_coords, local_block, local_blocks)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import moe
from repro_torch.models.common import init_params
from repro_torch.optim import SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

ARCHS = {"qwen3": "qwen3_moe_30b_a3b", "deepseek": "deepseek_v2_236b"}
CFS = {"cf8": 8.0, "cf1_25": 1.25}
MESHES = {"2x4": (2, 4), "1x4": (1, 4)}
BITS = (16, 8)
CASES = [(a, c, m, b) for a in ARCHS for c in CFS for m in MESHES
         for b in BITS]
# T = 512 tokens: 64 a rank on (2, 4) and 128 on (1, 4), so that the
# 1.25 capacity (24 and 40 slots a rank) drops choices
X_SHAPE = (4, 128, 64)
TOL = 2e-5
AUX_RTOL = 1e-5
GRID = 1.0 / 16
# a token's k-th and (k+1)-th probabilities closer than this are a tie
TIE_GAP = 1e-6
ROUTER_GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-4
# the parameters after the steps, as tests/test_torch_checkpoint.py holds
# them: an element whose gradient crossed a rounding boundary of the
# gradient or weight grid in one framework and not the other moves by a
# few weight-grid steps, and few elements do (the same step without a mesh
# agrees with the reference as closely: 14 elements of 156,992 on the CPU);
# the leaves the policy leaves unquantized (router, norms) move by fp32
# roundings, below PARAM_ATOL
PARAM_DIFF_STEPS = 4
PARAM_DIFF_FRACTION = 5e-4
PARAM_ATOL = 1e-6
EP_TRAIN = dict(steps=2, seq=16, batch=4)
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")

_rng = np.random.default_rng(230)
X = _rng.standard_normal(X_SHAPE).astype(np.float32)
W = _rng.standard_normal(X_SHAPE).astype(np.float32)
# grid values, half steps (ties both ways), saturating values, and noise
PACK_X = np.concatenate([
    (np.arange(-300, 300) + 0.5) / 16, np.arange(-140, 140) / 16,
    np.array([-8.03125, -8.0, 7.96875, 7.9375, 1e6, -1e6, 0.0, -0.0]),
    _rng.standard_normal(4096) * 3]).astype(np.float32)


def _cfg(arch, cf, bits=16):
    return dataclasses.replace(smoke(get_config(ARCHS[arch])),
                               capacity_factor=CFS[cf], moe_a2a_bits=bits)


def _tag(case):
    return "a2a/" + "/".join(map(str, case))


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for case in CASES:
        arch, cf, m, bits = case
        jobs.append({"job": "moe_a2a", "tag": _tag(case), "kw": {
            "seed": 0, "arch": ARCHS[arch], "mesh": list(MESHES[m]),
            "overrides": {"capacity_factor": CFS[cf],
                          "moe_a2a_bits": bits}}})
        arrays[_tag(case) + "/x"], arrays[_tag(case) + "/w"] = X, W
    jobs.append({"job": "a2a_pack", "tag": "pack", "kw": {}})
    arrays["pack/x"] = PACK_X
    for bits in BITS:
        jobs.append({"job": "ep_train", "tag": f"ep{bits}", "kw": dict(
            EP_TRAIN, arch=ARCHS["qwen3"], mesh=[2, 4],
            overrides={"moe_a2a_bits": bits})})
    return run_reference(jobs, arrays, host_devices=8)


def _params(ref, tag):
    return tree_lib.map_tree(lambda a: torch.from_numpy(a).requires_grad_(),
                             unflatten(ref, tag + "/params/"))


def _run(cfg, p, x, w, mesh):
    """moe_apply under ``mesh`` (None: unbound): (out, aux, grads of
    sum(out * w) + aux by leaf path, x's gradient); an unreached leaf's
    gradient is None."""
    x = x.clone().requires_grad_()
    leaves = tree_lib.leaves(p)
    before = dict(moe.DISPATCH_COUNTS)
    if mesh is None:
        y, aux = moe.moe_apply(cfg, p, x)
    else:
        with axis_rules(mesh, LogicalRules()):
            y, aux = moe.moe_apply(cfg, p, x)
    path = "a2a" if moe.DISPATCH_COUNTS["a2a"] > before["a2a"] else "einsum"
    g = torch.autograd.grad((y * w).sum() + aux, [x] + leaves,
                            allow_unused=True)
    grads = dict(zip([k for k, _ in tree_lib.leaves_with_path(p)], g[1:]))
    return y.detach(), aux.detach(), grads, g[0], path


def _rank_probs(cfg, p, x, mesh):
    """Every rank's router probabilities on its own token block."""
    spec, _ = moe.a2a_specs(mesh)
    out = []
    for c in held_coords(mesh):
        blk = local_block(x, spec, mesh, c).reshape(-1, x.shape[-1])
        out.append(moe._router(cfg, p["router"], blk)[2].detach())
    return out


def _beyond(a, b, tol):
    return int((np.abs(a - b) > tol).sum())


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_a2a_matches_reference(ref, case):
    arch, cf, m, bits = case
    cfg, tag = _cfg(arch, cf, bits), _tag(case)
    p = _params(ref, tag)
    mesh = mesh_lib.make_mesh(MESHES[m], ("data", "model"))
    x, w = torch.from_numpy(X), torch.from_numpy(W)
    # tie-free routing: torch.topk and lax.top_k agree only there
    for probs in _rank_probs(cfg, p, x, mesh):
        srt = np.sort(probs.numpy(), axis=-1)[:, ::-1]
        assert np.min(srt[:, :cfg.top_k] - srt[:, 1:cfg.top_k + 1]) > TIE_GAP
    y, aux, grads, gx, path = _run(cfg, p, x, w, mesh)
    assert path == "a2a"
    np.testing.assert_allclose(float(aux), float(ref[tag + "/aux"]),
                               rtol=AUX_RTOL)
    experts = {("w_in",), ("w_gate",), ("w_out",)}
    if bits == 16:
        assert np.max(np.abs(y.numpy() - ref[tag + "/y"])) <= TOL
        assert np.max(np.abs(gx.numpy() - ref[tag + "/gx"])) <= TOL
    else:
        # one grid step where a half step rounded the other way, else TOL
        for got, want in ((y.numpy(), ref[tag + "/y"]),
                          (gx.numpy(), ref[tag + "/gx"])):
            assert np.max(np.abs(got - want)) <= GRID + TOL
            assert _beyond(got, want, TOL) <= 1e-3 * got.size
    for path_, g in grads.items():
        want = ref[tag + "/grads/" + "/".join(path_)]
        if bits == 8 and path_ in experts:
            # the int8 cast cuts autograd in both packages
            assert g is None and not np.any(want), path_
            continue
        got = g.numpy()
        if bits == 16:
            assert np.max(np.abs(got - want)) <= TOL * max(
                1.0, np.max(np.abs(want))), path_
        else:
            assert _beyond(got, want, TOL * max(1.0, np.max(np.abs(want)))) \
                <= 1e-3 * got.size, path_


def test_capacity_1_25_drops_choices_and_8_none(ref):
    """The cf 1.25 cases exercise the drop row; cf 8 keeps every choice
    (so the a2a equals the einsum dispatch there)."""
    for arch in ARCHS:
        for m, shape in MESHES.items():
            for cf in CFS:
                cfg = _cfg(arch, cf)
                p = _params(ref, _tag((arch, cf, m, 16)))
                mesh = mesh_lib.make_mesh(shape, ("data", "model"))
                spec, _ = moe.a2a_specs(mesh)
                dropped = 0
                for c in held_coords(mesh):
                    blk = local_block(torch.from_numpy(X), spec, mesh, c)
                    x2 = blk.reshape(-1, cfg.d_model)
                    _, top_i, _ = moe._router(cfg, p["router"], x2)
                    _, keep = moe._slots(cfg, top_i,
                                         moe._capacity(x2.shape[0], cfg))
                    dropped += int((~keep).sum())
                assert (dropped > 0) == (cf == "cf1_25"), (arch, m, cf)


@pytest.mark.parametrize("arch", ARCHS)
def test_a2a_equals_einsum_without_drops(ref, arch):
    cfg = _cfg(arch, "cf8")
    p = _params(ref, _tag((arch, "cf8", "2x4", 16)))
    x, w = torch.from_numpy(X), torch.from_numpy(W)
    y0, a0, g0, gx0, path0 = _run(cfg, p, x, w, None)
    y1, a1, g1, gx1, path1 = _run(
        cfg, p, x, w, mesh_lib.make_mesh((2, 4), ("data", "model")))
    assert (path0, path1) == ("einsum", "a2a")
    assert torch.max(torch.abs(y0 - y1)) <= TOL
    assert torch.max(torch.abs(gx0 - gx1)) <= TOL
    assert abs(float(a0) - float(a1)) <= AUX_RTOL * abs(float(a0))
    for k in g0:
        scale = max(1.0, float(torch.max(torch.abs(g0[k]))))
        assert torch.max(torch.abs(g0[k] - g1[k])) <= TOL * scale, k


def test_a2a_pack_is_bit_equal_ties_included(ref):
    x = torch.from_numpy(PACK_X)
    for name, v in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        q = moe._a2a_pack(v)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), ref[f"pack/{name}/q"])
        np.testing.assert_array_equal(
            moe._a2a_unpack(q, torch.float32).numpy(),
            ref[f"pack/{name}/back"])
    # half to even, not the quantizer's floor(y + 1/2)
    assert moe._a2a_pack(torch.tensor([0.5 / 16, 1.5 / 16, -0.5 / 16])
                         ).tolist() == [0, 2, 0]


@pytest.mark.parametrize("shape,mesh", [
    ((4, 6, 64), (2, 4)),          # S % m
    ((3, 8, 64), (2, 4)),          # B % d
    ((4, 8, 64), (1, 16)),         # E % m (8 experts)
    ((4, 8, 64), (4, 1)),          # no model axis larger than 1
])
def test_gate_falls_back_to_einsum(ref, shape, mesh):
    cfg = _cfg("qwen3", "cf1_25")
    p = _params(ref, _tag(("qwen3", "cf1_25", "2x4", 16)))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y0, a0, g0, gx0, _ = _run(cfg, p, x, w, None)
    y1, a1, g1, gx1, path = _run(cfg, p, x, w, StackedMesh(mesh,
                                                           ("data", "model")))
    assert path == "einsum"
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert torch.equal(gx0, gx1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ---------------------------------------------------------------------------
# the body over gloo processes against the stacked body
# ---------------------------------------------------------------------------

GLOO_BITS = (16, 8)


def _body(mesh, cfg, p, x, w, aux_weight):
    """``_moe_a2a_local`` on the ranks ``mesh`` holds; the loss is each
    rank's ``sum(out * w)``, summed over the ranks held, plus ``aux_weight``
    times the aux loss: the aux loss counts once, on rank 0, and every
    other process takes it times 0, so that its backward still joins the
    collectives of the mean.  Returns per held rank (out,
    x-block grad, expert-shard grads), the aux loss and the router grad."""
    x_spec, w_spec = moe.a2a_specs(mesh)
    coords = held_coords(mesh)
    x = x.clone().requires_grad_()
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    cut = lambda t, s: local_blocks(t, s, mesh, coords)
    outs, aux = moe._moe_a2a_local(cfg, mesh, coords, cut(x, x_spec),
                                   p["router"], cut(p["w_in"], w_spec),
                                   cut(p["w_gate"], w_spec),
                                   cut(p["w_out"], w_spec))
    loss = sum((o * wb).sum() for o, wb in zip(outs, cut(w, x_spec)))
    loss = loss + aux_weight * aux
    leaves = [x, p["router"], p["w_in"], p["w_gate"], p["w_out"]]
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    zero = lambda t, ref_: torch.zeros_like(ref_) if t is None else t
    g = [zero(t, l) for t, l in zip(g, leaves)]
    per_rank = [(o.detach(), local_block(g[0], x_spec, mesh, c),
                 [local_block(gw, w_spec, mesh, c) for gw in g[2:]])
                for o, c in zip(outs, coords)]
    return per_rank, aux.detach(), g[1]


def _gloo_inputs(bits):
    cfg = _cfg("qwen3", "cf1_25", bits)
    gen = torch.Generator().manual_seed(3)
    p = init_params(moe.moe_defs(cfg, torch.float32), "cpu", gen)
    return cfg, p, torch.from_numpy(X), torch.from_numpy(W)


def _gloo_rank(rank, world, store_path, out_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_mesh((1, world), ("data", "model"))
        out = {bits: _body(mesh, *_gloo_inputs(bits),
                           aux_weight=float(rank == 0))
               for bits in GLOO_BITS}
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_gloo_body_is_bit_equal_to_the_stacked_body(one_thread, tmp_path):
    world = 4
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, world, str(tmp_path / "store"),
                               str(tmp_path / "out")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    runs = [torch.load(tmp_path / f"out.{r}") for r in range(world)]
    stacked = StackedMesh((1, world), ("data", "model"))
    for bits in GLOO_BITS:
        want, want_aux, want_router = _body(stacked, *_gloo_inputs(bits),
                                            aux_weight=1.0)
        router = torch.zeros_like(want_router)
        for r, run in enumerate(runs):
            (got,), aux, g_router = run[bits]
            out, gx, gw = got
            assert torch.equal(out, want[r][0]), (bits, r)
            assert torch.equal(aux, want_aux), (bits, r)
            assert torch.equal(gx, want[r][1]), (bits, r)
            for a, b in zip(gw, want[r][2]):
                assert torch.equal(a, b), (bits, r)
            router += g_router
        if bits == 8:
            assert not any(torch.any(g) for g in want[0][2])
        scale = float(torch.max(torch.abs(want_router)))
        assert torch.max(torch.abs(router - want_router)) \
            <= ROUTER_GRAD_RTOL * scale, bits


# ---------------------------------------------------------------------------
# a training step under the stacked mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_ep_step_matches_reference_sharded_step(ref, bits):
    """With the int8 payload the experts' gradient is zero in both
    packages (the step's gradient of a leaf the loss does not reach is 0,
    as the reference's)."""
    cfg = dataclasses.replace(smoke(get_config(ARCHS["qwen3"])),
                              remat="full", moe_a2a_bits=bits)
    tag = f"ep{bits}"
    params = params_from_jax(unflatten(ref, f"{tag}/params/"), cfg, "cpu",
                             training=True)
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = specs.build_train_step(cfg, qcfg, opt, accum_steps=1)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab,
                                         seq_len=EP_TRAIN["seq"],
                                         global_batch=EP_TRAIN["batch"],
                                         seed=0))
    hist = {k: [] for k in FMTS + ("loss",)}
    before = dict(moe.DISPATCH_COUNTS)
    with axis_rules(mesh_lib.make_mesh((2, 4), ("data", "model")),
                    LogicalRules()):
        for i in range(EP_TRAIN["steps"]):
            state, m = step(state, data.batch(i))
            for k in hist:
                hist[k].append(float(m[k]))
    assert moe.DISPATCH_COUNTS["einsum"] == before["einsum"]
    assert moe.DISPATCH_COUNTS["a2a"] > before["a2a"]
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"{tag}/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref[f"{tag}/hist/loss"],
                               rtol=LOSS_RTOL)
    want = params_from_jax(unflatten(ref, f"{tag}/final/"), cfg, "cpu",
                           training=True)
    grid = 2.0 ** -hist["fl_w"][-1]
    total = differ = 0
    for (k, a), (_, b) in zip(tree_lib.leaves_with_path(state.params),
                              tree_lib.leaves_with_path(want)):
        gap = torch.abs(a - b)
        assert torch.max(gap) <= PARAM_DIFF_STEPS * grid, k
        total += gap.numel()
        differ += int((gap > PARAM_ATOL).sum())
    assert differ <= PARAM_DIFF_FRACTION * total, (differ, total)
