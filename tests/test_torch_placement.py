"""Placement rank by rank: a state cut into the blocks each rank holds, the
block Philox stream, statistics merged over a tensor's split axes, the
transports' collectives and a placed checkpoint.

* ``place`` / ``gather_placed`` round-trip every leaf of the 10 archs'
  smoke states (parameters and SGD momentum) bit for bit at (1, 4), (2, 4)
  and (16, 16); each block has the spec's shape, and the bytes each rank
  holds equal the spec's blocks exactly.
* ``philox_bits`` with a block geometry is bit-equal to the slice of the
  whole tensor's stream for every spec llama3.2-3b's leaves and residual
  stream take at those meshes (a table of them is written by
  :func:`llama_geometries`), and so is the operand path
  (``ops.block_event_bits`` without the in-kernel generator).  A block
  that folds to more than three strided dims raises.
* ``quantize_placed`` at nearest: q bit-equal to the whole tensor's, the
  merged statistics' integers and ``max_abs`` exact and the float sums
  within 1e-6 relative of the whole tensor's.
* Each collective of the transports and its autograd rule: a stacked axis
  against a gloo group of four processes, bit-equal in fp32.
* A checkpoint saved from a placed (2, 4) state restores bit-equal
  unsharded, placed again at (1, 4), and through the reference's own
  ``restore`` onto none, (1, 4) and (2, 4) meshes (job
  ``elastic_restore``); over a gloo (2, 2) ``DeviceMesh`` every process
  flattens the whole state.
"""

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import flatten_tree, restore, save
from repro_torch.configs.base import ARCH_NAMES, get_config, smoke
from repro_torch.core import fixed_point as fxp
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (LogicalRules, Placed, StackedMesh,
                                       block_shape, gather_placed, held_bytes,
                                       place_tensor, spec_bytes)
from repro_torch.dist.transport import StackedTransport
from repro_torch.kernels import dps_quant, ops
from repro_torch.launch import specs
from repro_torch.models import registry
from repro_torch.models.common import abstract_params, init_params
from repro_torch.optim import SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference  # noqa: F401

MESHES = ((1, 4), (2, 4), (16, 16))
AXES = ("data", "model")
SUM_RTOL = 1e-6


def _mesh(shape):
    return StackedMesh(shape, AXES)


def _smoke_state(arch):
    cfg = smoke(get_config(arch))
    defs = registry(cfg.family).model_defs(cfg, cfg.master_dtype())
    params = init_params(defs, "cpu", torch.Generator().manual_seed(0))
    opt = make_optimizer(SGDConfig())
    mu = tree_lib.map_tree(lambda p: torch.randn(p.shape, dtype=p.dtype,
                                                 generator=torch.Generator()
                                                 .manual_seed(p.numel())),
                           params)
    state = qtrain.TrainState.create(params, {"mu": mu},
                                     qtrain.QuantConfig(), 1)
    return cfg, opt, state


# ---------------------------------------------------------------------------
# place / gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_place_gather_roundtrip_and_bytes(arch):
    cfg, opt, state = _smoke_state(arch)
    whole = {"params": state.params, "opt": state.opt_state}
    want = tree_lib.map_tree(torch.clone, whole)
    aparams = abstract_params(registry(cfg.family).model_defs(cfg))
    for shape in MESHES:
        mesh = _mesh(shape)
        p_specs = specs.param_shardings(cfg, mesh, LogicalRules())
        placed = {"params": sharding.place(want["params"], p_specs, mesh),
                  "opt": {"mu": sharding.place(want["opt"]["mu"], p_specs,
                                               mesh)}}
        got = gather_placed(placed)
        for (path, a), (_, b) in zip(tree_lib.leaves_with_path(got),
                                     tree_lib.leaves_with_path(want)):
            assert torch.equal(a, b), (shape, path)
        for (path, leaf), (_, spec) in zip(
                tree_lib.leaves_with_path(placed["params"]),
                tree_lib.leaves_with_path(p_specs)):
            blk = block_shape(leaf.shape, spec, mesh)
            assert all(tuple(b.shape) == blk for b in leaf.blocks), path
        # every rank holds its blocks of the parameters and the momentum
        # (fp32 master, placed like its parameter): the spec's bytes
        per_rank = 2 * spec_bytes(
            tree_lib.map_tree(lambda t: t.to(torch.float32), aparams),
            p_specs, mesh)
        assert held_bytes(placed) == [per_rank] * math.prod(shape)
        n = sum(math.prod(block_shape(l.shape, s, mesh)) for l, s in zip(
            tree_lib.leaves(placed["params"]), tree_lib.leaves(p_specs)))
        assert per_rank == 2 * 4 * n


def test_place_train_state_places_in_place():
    cfg, opt, state = _smoke_state("llama3_2_3b")
    tok = state.params["embed"]["tok"].clone()
    mesh = _mesh((2, 4))
    out = specs.place_train_state(cfg, state, mesh)
    assert out is state
    leaf = state.params["embed"]["tok"]
    assert isinstance(leaf, Placed) and leaf.spec == ("model", None)
    # ranks that hold the same block (replicated over data) share it
    assert leaf.blocks[0] is leaf.blocks[4]
    assert isinstance(state.opt_state["mu"]["embed"]["tok"], Placed)
    assert torch.equal(gather_placed(leaf), tok)


# ---------------------------------------------------------------------------
# the block Philox stream
# ---------------------------------------------------------------------------

def llama_geometries():
    """Every (tensor, mesh, spec) of llama3.2-3b's leaves and residual
    stream at the three meshes, with the geometry that covers a rank's
    block: ``contiguous`` (one run of the whole tensor's stream), ``2-D``
    (rows of a column block) or ``3-D`` (a column block of each row block
    of each layer).  The full-size shapes: the geometry is a function of
    the spec and the shape."""
    cfg = get_config("llama3_2_3b")
    defs = registry(cfg.family).model_defs(cfg)
    rows = []
    for shape in MESHES:
        mesh = _mesh(shape)
        p_specs = specs.param_shardings(cfg, mesh, LogicalRules())
        tensors = [("/".join(p), d.shape, s) for (p, d), (_, s) in zip(
            tree_lib.leaves_with_path(defs), tree_lib.leaves_with_path(p_specs))]
        for B, S in ((4, 512), (32, 4096)):
            act = (B, S, cfg.d_model)
            tensors.append((f"residual {B}x{S}", act, LogicalRules().spec(
                ("batch", "tp_seq", "embed"), act, mesh)))
        for name, full, spec in tensors:
            blk = block_shape(full, spec, mesh)
            coord = (shape[0] - 1, shape[1] - 1)
            origin = sharding.block_origin(full, spec, mesh, coord)
            geo = dps_quant.block_geometry(full, origin, blk)
            n0 = math.prod(blk) // (geo.n1 * geo.n2)
            kind = ("contiguous" if n0 == 1 and geo.n1 == 1
                    else "2-D" if n0 == 1 else "3-D")
            rows.append((name, shape, spec, blk, kind))
    return rows


def test_llama_geometries_are_all_expressible():
    rows = llama_geometries()
    kinds = {(name, shape): kind for name, shape, _, _, kind in rows}
    # the stacked (L, D, F) leaves: split on F alone, rows of a column
    # block; on D (FSDP) and F, a column block of each layer's row block
    assert kinds[("layers/mlp/w_in", (1, 4))] == "2-D"
    assert kinds[("layers/mlp/w_in", (2, 4))] == "3-D"
    assert kinds[("layers/mlp/w_in", (16, 16))] == "3-D"
    assert kinds[("embed/tok", (1, 4))] == "contiguous"
    assert kinds[("residual 4x512", (2, 4))] == "2-D"


def _smoke_geometries():
    """The same specs at smoke size (what a test can draw whole)."""
    cfg = smoke(get_config("llama3_2_3b"))
    defs = registry(cfg.family).model_defs(cfg)
    out = []
    for shape in MESHES:
        mesh = _mesh(shape)
        p_specs = specs.param_shardings(cfg, mesh, LogicalRules())
        tensors = [(d.shape, s) for d, s in zip(tree_lib.leaves(defs),
                                                tree_lib.leaves(p_specs))]
        act = (16, 32, cfg.d_model)
        tensors.append((act, LogicalRules().spec(("batch", "tp_seq", "embed"),
                                                 act, mesh)))
        out.append((shape, mesh, tensors))
    return out


@pytest.mark.parametrize("at", range(len(MESHES)))
def test_block_philox_equals_the_whole_stream_slice(at):
    shape, mesh, tensors = _smoke_geometries()[at]
    coords = sharding.held_coords(mesh)
    pick = coords if len(coords) <= 8 else coords[::37]
    for full, spec in tensors:
        n = math.prod(full)
        whole = dps_quant.philox_bits(77, n).view(full)
        whole_op = ops.operand_bits(77, n, "cpu").view(full)
        blk = block_shape(full, spec, mesh)
        for c in pick:
            origin = sharding.block_origin(full, spec, mesh, c)
            sl = tuple(slice(o, o + b) for o, b in zip(origin, blk))
            geo = dps_quant.block_geometry(full, origin, blk)
            got = dps_quant.philox_bits(77, math.prod(blk), block=geo)
            assert torch.equal(got.view(blk), whole[sl]), (full, spec, c)
            bits = ops.block_event_bits(full, origin, blk, "stochastic", 77,
                                        True, "cpu")
            assert isinstance(bits, dps_quant.Philox)
            op = ops.block_event_bits(full, origin, blk, "stochastic", 77,
                                      False, "cpu")
            assert torch.equal(op.view(blk), whole_op[sl]), (full, spec, c)


def test_unfoldable_block_raises():
    with pytest.raises(ValueError, match="at most three"):
        dps_quant.block_geometry((4, 4, 4, 4), (0, 2, 0, 2), (2, 2, 2, 2))
    with pytest.raises(ValueError, match="takes no offset"):
        dps_quant.Philox(1, offset=4, block=dps_quant.block_geometry(
            (4, 4), (0, 0), (4, 2)))


# ---------------------------------------------------------------------------
# statistics merged over the split axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nearest", "stochastic"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
def test_merged_block_stats_equal_whole_tensor_stats(shape, mode):
    mesh = _mesh(shape)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 64, 96, generator=g) * 4.0
    x[:, ::5] = 0.0
    spec = (None, "data" if shape[0] > 1 else None, "model")
    fmt = fxp.FixedPointFormat.create(2, 6)
    qw, sw = fxp.quantize_tree_leaf(0, ("w",), x, fmt, mode=mode, seed=9,
                                    onchip_prng=True)
    qp, sp = fxp.quantize_placed(0, ("w",), place_tensor(x, spec, mesh), fmt,
                                 mode=mode, seed=9, onchip_prng=True)
    assert torch.equal(gather_placed(qp), qw)
    for f in ("count", "nonzero", "overflow", "max_abs"):
        assert torch.equal(getattr(sp, f), getattr(sw, f)), f
    for f in ("abs_err_sum", "rel_err_sum", "abs_sum"):
        a, b = float(getattr(sp, f)), float(getattr(sw, f))
        assert abs(a - b) <= SUM_RTOL * abs(b), (f, a, b)


# ---------------------------------------------------------------------------
# the transports' collectives: stacked against gloo
# ---------------------------------------------------------------------------

N_PG = 4


def _collective_inputs():
    g = torch.Generator().manual_seed(11)
    xs = [torch.randn(3, 8, generator=g) for _ in range(N_PG)]
    gs = [torch.randn(3, 8 * N_PG, generator=g) for _ in range(N_PG)]
    gr = [torch.randn(3, 2, generator=g) for _ in range(N_PG)]
    gp = [torch.randn(3, 8, generator=g) for _ in range(N_PG)]
    return xs, gs, gr, gp


def _collectives(t, xs, gs, gr, gp, ranks):
    """Each collective's forward and its gradient under the cotangents
    ``gs`` (gather), ``gr`` (reduce-scatter) and ``gp`` (sums), for the
    ranks held (``ranks``)."""
    out = {}
    cases = (("gather", lambda a: t.gather_blocks(a, 1), gs),
             ("reduce_scatter", lambda a: t.reduce_scatter_blocks(a, 1), gr),
             ("psum", lambda a: t.psum_blocks(a), gp),
             ("psum_id", lambda a: t.psum_blocks(a, grad="identity"), gp),
             ("copy", lambda a: t.copy_blocks(a), gp))
    for name, fn, cot in cases:
        a = [xs[r].clone().requires_grad_() for r in ranks]
        y = fn(a)
        grads = torch.autograd.grad(y, a, [cot[r] for r in ranks])
        out[name] = ([v.detach() for v in y], list(grads))
    out["pmax"] = (t.pmax_blocks([xs[r] for r in ranks]), [])
    return out


def _pg_rank(rank, store_path, out_path, library=False):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, N_PG)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=N_PG)
    try:
        from repro_torch.dist import transport
        if library:
            # the path every backend but gloo takes (NCCL on the card)
            transport._rank_ordered = lambda group: False
        res = _collectives(transport.ProcessGroupTransport(),
                           *_collective_inputs(), [rank])
        torch.save(res, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def _spawn_pg(tmp_path, library=False):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_pg_rank, args=(r, str(tmp_path / "store"),
                                                str(tmp_path / "out"),
                                                library))
             for r in range(N_PG)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * N_PG


def test_collectives_stacked_equal_gloo_bit_for_bit(one_thread, tmp_path):
    _spawn_pg(tmp_path)
    want = _collectives(StackedTransport(N_PG), *_collective_inputs(),
                        list(range(N_PG)))
    xs, gs, gr, gp = _collective_inputs()
    # the stacked rules themselves: rank-order sums and the transposes
    tot = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert torch.equal(want["psum"][0][2], tot)
    assert torch.equal(want["gather"][0][1], torch.cat(xs, 1))
    assert torch.equal(want["psum_id"][1][3], gp[3])
    assert torch.equal(want["copy"][0][1], xs[1])
    for r in range(N_PG):
        got = torch.load(tmp_path / f"out.{r}")
        for name, (ys, grads) in want.items():
            (y,), g = got[name]
            assert torch.equal(y, ys[r]), (name, r)
            if grads:
                assert torch.equal(g[0], grads[r]), (name, r)


def test_collectives_on_the_library_path_equal_stacked(one_thread,
                                                        tmp_path):
    """The library's ``reduce_scatter_tensor`` and ``all_reduce`` (every
    backend but gloo: no ``n``-fold buffer), run over gloo: the stacked
    axis's values and gradients within fp32 summation-order error, the
    gathers and the max exactly."""
    _spawn_pg(tmp_path, library=True)
    want = _collectives(StackedTransport(N_PG), *_collective_inputs(),
                        list(range(N_PG)))
    for r in range(N_PG):
        got = torch.load(tmp_path / f"out.{r}")
        for name, (ys, grads) in want.items():
            (y,), g = got[name]
            torch.testing.assert_close(y, ys[r], rtol=1e-6, atol=1e-6)
            if grads:
                torch.testing.assert_close(g[0], grads[r], rtol=1e-6,
                                           atol=1e-6)
        assert torch.equal(got["gather"][0][0], want["gather"][0][r])
        assert torch.equal(got["pmax"][0][0], want["pmax"][0][r])


# ---------------------------------------------------------------------------
# a placed checkpoint restores whole and onto any mesh
# ---------------------------------------------------------------------------

def test_placed_checkpoint_restores_whole_and_on_other_meshes(tmp_path):
    cfg, opt, state = _smoke_state("llama3_2_3b")
    want = flatten_tree(state)
    specs.place_train_state(cfg, state, _mesh((2, 4)))
    root = str(tmp_path / "ck")
    save(root, 3, state)
    cfg2, _, fresh = _smoke_state("llama3_2_3b")
    fresh = tree_lib.map_tree(torch.zeros_like, fresh.params)
    template = qtrain.TrainState.create(
        fresh, {"mu": tree_lib.map_tree(torch.zeros_like, fresh)},
        qtrain.QuantConfig(), 1)
    restored, _ = restore(root, 3, template)
    got = flatten_tree(restored)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    specs.place_train_state(cfg2, restored, _mesh((1, 4)))
    again = flatten_tree(restored)
    for k, v in want.items():
        assert np.array_equal(again[k], v), k
    ref = run_reference([{"job": "elastic_restore", "tag": "el",
                          "kw": {"root": root, "step": 3,
                                 "meshes": [[1, 4], [2, 4]]}}],
                        host_devices=8)
    for tag in ("none", "1x4", "2x4"):
        for k, v in want.items():
            if k.startswith(".params/"):
                assert np.array_equal(ref[f"el/{tag}/params/{k[8:]}"], v), \
                    (tag, k)
            if k.startswith(".opt_state/mu/"):
                assert np.array_equal(ref[f"el/{tag}/opt/mu/{k[14:]}"], v), \
                    (tag, k)


def _flatten_rank(rank, store_path, out_path):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, N_PG)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=N_PG)
    try:
        from repro_torch.launch.mesh import make_mesh
        cfg, _, state = _smoke_state("llama3_2_3b")
        mesh = make_mesh((2, 2), AXES)
        assert sharding._is_device_mesh(mesh)
        specs.place_train_state(cfg, state, mesh)
        torch.save(flatten_tree(state), f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_placed_checkpoint_over_processes_is_the_whole_state(one_thread,
                                                             tmp_path):
    """On a gloo ``DeviceMesh`` of 4 processes at (2, 2) every process's
    flattened state is the whole one, bit for bit: each leaf built on the
    host block by block, each block broadcast from its lowest holder."""
    cfg, _, state = _smoke_state("llama3_2_3b")
    want = flatten_tree(state)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_flatten_rank,
                         args=(r, str(tmp_path / "store"),
                               str(tmp_path / "flat")))
             for r in range(N_PG)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * N_PG
    for r in range(N_PG):
        got = torch.load(tmp_path / f"flat.{r}", weights_only=False)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), (r, k)
