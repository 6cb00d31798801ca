"""Placement in the port against the JAX package's: the logical sharding
rules, the specs of every train-state, batch, cache and prefill leaf, and a
step under a stacked mesh.

* ``LogicalRules.resolve_dim`` on a duck-typed (4, 8) mesh, case by case
  (the divisibility fallback, joint axes, a mesh axis never used twice in a
  tensor) against the reference's (job ``rules``).
* Every arch's specs, **exactly**, at both production meshes — (16, 16) and
  (2, 16, 16) — and at a 16-way data mesh, where ZeRO-1 engages: the
  parameters and the optimizer state under SGD and AdamW, replicated and
  with ``zero_opt_shards`` (the flat layout, ``("data",)``, where the
  reference's ``zero_opt_engaged`` holds), and at each of its shapes the
  batch, the decode cache or the prefill inputs (job ``specs``, which runs
  the reference's own ``repro.launch.specs`` on a mesh that holds no
  devices).
* The mesh helpers: a block cut and stitched back, the stacked tiled
  all-to-all against explicit concatenation, ``logical_constraint`` the
  identity, ``make_mesh``'s kinds.
* A smoke llama3.2-3b step under a stacked (2, 4) mesh, bit-equal to the
  step without one (no MoE layer: the constraints change no value).
"""

import contextlib
import dataclasses
import json

import pytest
import torch

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, applicable_shapes,
                                      get_config, smoke)
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.dist.sharding import (LogicalRules, StackedMesh, axis_rules,
                                       current_mesh_rules, held_coords,
                                       local_block, local_blocks,
                                       logical_constraint,
                                       model_axis_size, stitch_blocks)
from repro_torch.dist.transport import StackedTransport
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import registry
from repro_torch.models.common import abstract_params, init_params
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference  # noqa: F401

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "data16": ((16,), ("data",))}
RULE_MESH = ((4, 8), ("data", "model"))
# (logical, dim, taken): 30 and 2 do not divide their axes (replicated);
# batch2d takes data and model jointly; an axis taken by an earlier dim of
# the same tensor is skipped
RULE_CASES = [("tp", 30, []), ("tp", 32, []), ("batch", 8, []),
              ("batch", 2, []), ("kv", 32, ["model"]), ("batch2d", 64, []),
              ("batch2d", 16, []), ("batch2d", 64, ["model"]),
              ("fsdp", 12, []), ("embed", 32, []), (None, 32, []),
              ("heads", 8, []), ("vocab_out", 128512, []), ("expert", 4, [])]


@pytest.fixture(scope="module")
def ref():
    return run_reference([
        {"job": "specs", "tag": "specs", "kw": {
            "archs": list(ARCH_NAMES),
            "meshes": {k: [list(s), list(a)] for k, (s, a) in MESHES.items()}}},
        {"job": "rules", "tag": "rules", "kw": {
            "cases": RULE_CASES,
            "mesh": [list(RULE_MESH[0]), list(RULE_MESH[1])]}}])


def _jsonable(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, struct, prefix):
    """``{"<prefix>/<leaf path>": spec}`` of a spec tree, walked beside the
    tree of stand-ins it was resolved against."""
    if isinstance(struct, torch.Tensor):
        return {prefix: _jsonable(tree)}
    items = (struct.items() if isinstance(struct, dict)
             else enumerate(struct))
    out = {}
    for k, v in items:
        out.update(_flat(tree[k], v, f"{prefix}/{k}"))
    return out


def _port_specs(arch, mname):
    mesh = (mesh_lib.make_production_mesh(multi_pod=mname == "multipod")
            if mname != "data16" else mesh_lib.make_mesh(*MESHES[mname]))
    rules = LogicalRules()
    cfg = get_config(arch)
    mod = registry(cfg.family)
    aparams = abstract_params(mod.model_defs(cfg))
    n_data = dict(zip(MESHES[mname][1], MESHES[mname][0])).get("data", 1)
    out = {}
    for oname, opt in (("sgd", make_optimizer(SGDConfig())),
                       ("adamw", make_optimizer(AdamWConfig()))):
        for zname, zero in (("repl", None), ("zero", n_data)):
            q = qtrain.QuantConfig(zero_opt_shards=zero)
            st = specs.train_state_shardings(cfg, mesh, rules, opt, q)
            pre = f"{mname}/{arch}/{oname}_{zname}"
            out.update(_flat(st.params, aparams, pre + "/params"))
            opt_struct = specs._abstract_opt_state(aparams, opt, q, mesh)
            if specs.zero_engaged(q, mesh):
                assert all(s.dim() == 1 for s in opt_struct.values())
            out.update(_flat(st.opt_state, opt_struct, pre + "/opt_state"))
    for sname in applicable_shapes(cfg):
        shp = SHAPES[sname]
        struct = {"train": specs.train_batch_specs,
                  "decode": specs.decode_specs,
                  "prefill": specs.prefill_specs}[shp.kind](cfg, shp)
        fn = {"train": specs.train_batch_shardings,
              "decode": specs.decode_shardings,
              "prefill": specs.prefill_shardings}[shp.kind]
        out.update(_flat(fn(cfg, shp, mesh, rules), struct,
                         f"{mname}/{arch}/{sname}"))
    return out


def test_logical_rules_match_reference_case_by_case(ref):
    want = json.loads(str(ref["rules/res"]))
    mesh = StackedMesh(*RULE_MESH)
    for (logical, dim, taken), (axis, taken_after) in zip(RULE_CASES, want):
        t = set(taken)
        got = LogicalRules().resolve_dim(logical, dim, mesh, t)
        assert (list(got) if isinstance(got, tuple) else got) == axis, \
            (logical, dim, taken)
        assert sorted(t) == taken_after, (logical, dim, taken)


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_the_reference_exactly(ref, arch, mname):
    want = {k: v for k, v in json.loads(str(ref["specs/specs"])).items()
            if k.startswith(f"{mname}/{arch}/")}
    got = _port_specs(arch, mname)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    # the meshes bind what they should somewhere: the model axis on the
    # production meshes, the flat ZeRO state on the data mesh
    vals = json.dumps(list(got.values()))
    assert ('"model"' in vals) == (mname != "data16")
    if mname == "data16":
        assert got[f"data16/{arch}/sgd_zero/opt_state/mu"] == ["data"]


def test_production_meshes_are_shape_only():
    one, two = (mesh_lib.make_production_mesh(),
                mesh_lib.make_production_mesh(multi_pod=True))
    assert (one.shape, one.axis_names) == ((16, 16), ("data", "model"))
    assert two.shape == (2, 16, 16) and two.size == 512
    assert two.transport("model").axis_size == 16
    host = mesh_lib.make_host_mesh()
    assert isinstance(host, StackedMesh) and host.shape == (1,)


def test_block_cut_and_stitch_round_trip():
    mesh = StackedMesh((2, 2, 4), ("pod", "data", "model"))
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    spec = (("pod", "data"), "model", None)
    coords = held_coords(mesh)
    blocks = [local_block(x, spec, mesh, c) for c in coords]
    assert blocks[0].shape == (2, 2, 3)
    # pod is major in the joint batch axis: rank (1, 0, 3) holds rows 4-5
    assert torch.equal(blocks[coords.index((1, 0, 3))], x[4:6, 6:8])
    assert torch.equal(stitch_blocks(blocks, spec, mesh, coords, x.shape), x)
    # one chunk a sharded dim gives the same blocks
    for a, b in zip(local_blocks(x, spec, mesh, coords), blocks):
        assert torch.equal(a, b)
    # a replicated dim: every model rank holds the same block
    rep = [local_block(x, (("pod", "data"), None, None), mesh, c)
           for c in coords]
    assert torch.equal(stitch_blocks(rep, (("pod", "data"), None, None),
                                     mesh, coords, x.shape), x)


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (2, 0)])
def test_stacked_all_to_all_is_explicit_concatenation(split, concat):
    n = 4
    x = torch.randn(n, 8, 12, 4, requires_grad=True)
    y = StackedTransport(n).all_to_all_tiled(x, split, concat)
    for j in range(n):
        want = torch.cat([x[i].tensor_split(n, dim=split)[j]
                          for i in range(n)], dim=concat)
        assert torch.equal(y[j], want)
    # autograd passes through, and the return trip is the inverse
    back = StackedTransport(n).all_to_all_tiled(y, concat, split)
    assert torch.equal(back, x)
    (g,) = torch.autograd.grad((y * y).sum(), x)
    assert torch.equal(g, 2 * x)


def test_constraint_is_the_identity_and_checks_its_rank():
    x = torch.randn(2, 8, 4)
    assert logical_constraint(x, "batch", "seq", "embed") is x
    assert model_axis_size() == 1 and current_mesh_rules() == (None, None)
    with axis_rules(StackedMesh((2, 4), ("data", "model")), LogicalRules()):
        assert model_axis_size() == 4
        assert logical_constraint(x, "batch", "tp_seq", "embed") is x
        with pytest.raises(AssertionError):
            logical_constraint(x, "batch", "embed")
    assert current_mesh_rules() == (None, None)


def test_binding_is_seen_from_another_thread():
    """torch's autograd runs a CUDA backward (and a checkpoint's recompute)
    on a thread of its own: it must see the forward's mesh."""
    import threading
    mesh = StackedMesh((1, 4), ("data", "model"))
    seen = []
    with axis_rules(mesh, LogicalRules()):
        t = threading.Thread(target=lambda: seen.append(
            current_mesh_rules()[0]))
        t.start()
        t.join()
    assert seen == [mesh]


def _llama_steps(mesh, steps=2):
    cfg = dataclasses.replace(smoke(get_config("llama3_2_3b")), remat="full")
    mod = registry(cfg.family)
    params = init_params(mod.model_defs(cfg, cfg.master_dtype()), "cpu",
                         torch.Generator().manual_seed(0))
    qcfg = qtrain.QuantConfig(enabled=True)
    opt = make_optimizer(SGDConfig())
    step = specs.build_train_step(cfg, qcfg, opt)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=16,
                                         global_batch=8, seed=0))
    hist = []
    ctx = axis_rules(mesh, LogicalRules()) if mesh else contextlib.nullcontext()
    with ctx:
        for i in range(steps):
            state, m = step(state, data.batch(i))
            hist.append({k: float(v) for k, v in m.items()})
    return hist, state.params


def test_llama_step_under_a_stacked_mesh_is_bit_equal(one_thread):
    h0, p0 = _llama_steps(None)
    h1, p1 = _llama_steps(mesh_lib.make_mesh((2, 4), ("data", "model")))
    assert h0 == h1
    for (k, a), (_, b) in zip(tree_lib.leaves_with_path(p0),
                              tree_lib.leaves_with_path(p1)):
        assert torch.equal(a, b), k
