"""The health guards, the fault drills and the rollback ring on the placed
(sharded) train step, against the JAX package's own sharded step.

* llama3.2-3b at smoke size, guarded (``GuardConfig()``), 3 SGD steps at
  nearest rounding placed on stacked (1, 4) and (2, 4) meshes: the NaN
  drill (``nan_grads_at=1``) and the overflow-storm drill
  (``overflow_storm_at=1`` with ``grad_allreduce_bits=8``, at (2, 4) also
  ``zero_opt_shards=2``: both fall back under the model axis, and the plan
  keeps their wire domains, so the trip lands on ``degraded``) against the
  reference's step jitted with the same guards, faults and flags on the
  same mesh (job ``sharded_step``): the health word, ``skipped``,
  ``trips``, ``degraded`` and every domain's format equal at every step,
  the losses within ``LOSS_RTOL``.
* Every family's guarded NaN step at (2, 4) against the port's own
  unsharded guarded step.
* The signals on placed trees: a NaN in one rank's block only is bad on
  every rank; the storm multiplies a block the ranks share once; a NaN in
  one rank's gradient block skips the step and holds every parameter and
  momentum block bit for bit.
* Through ``launch.train.main(..., mesh=...)``: the rollback ring restores
  its placed snapshot in place, as the unsharded ring run does; a guarded
  placed checkpoint resumes (under ``--grad-allreduce-bits 8 --zero-opt``,
  which fall back), and a guarded run resumes one written without guards.
* Over gloo, 2 processes on a (1, 2) mesh: a NaN in one process's block
  skips the step on both, and the CLI's guarded, faulted run with the ring
  armed gives both processes the same history.
* The placed bf16 step's activation statistics (E_a, R_a) and formats at
  (2, 4) against the reference's sharded bf16 step and against each
  package's unsharded step.

Every case shares one reference child (``ref``).
"""

import contextlib
import dataclasses
import json
import multiprocessing as mp
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.dist.sharding import (LogicalRules, Placed, StackedMesh,
                                       axis_rules, gather_placed, place)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.models.common import init_params
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.resilience import (FaultPlan, GuardConfig,
                                    HEALTH_GRADS_NONFINITE, HEALTH_SKIPPED)
from test_torch_jaxref import one_thread, run_reference  # noqa: F401
from test_torch_tp import (BATCH, FMTS, GUARD_KEYS, LOSS_RTOL, SEQ, STEPS,
                           _batch_extras, _cfg, _ref_params, _run)

# drill -> (faults, the step's flags at (1, 4), and at (2, 4))
DRILLS = {
    "nan": ({"nan_grads_at": 1}, {}, {}),
    "storm": ({"overflow_storm_at": 1}, {"grad_allreduce_bits": 8},
              {"grad_allreduce_bits": 8, "zero_opt_shards": 2}),
}
MESHES = [(1, 4), (2, 4)]
FAMILIES = ("llama3_2_3b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
            "internvl2_26b", "mamba2_1_3b", "zamba2_7b", "whisper_medium")
NAN_SKIP = HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED


def _tag(drill, shape):
    return f"{drill}{shape[0]}x{shape[1]}"


def _flags(drill, shape):
    return DRILLS[drill][1 if shape[0] == 1 else 2]


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "sharded_step", "tag": _tag(d, s),
             "kw": {"steps": STEPS, "seq": SEQ, "batch": BATCH,
                    "mesh": list(s), "guards": True, "faults": DRILLS[d][0],
                    "whole": False, **_flags(d, s)}}
            for d in DRILLS for s in MESHES]
    jobs.append({"job": "sharded_step", "tag": "bf16",
                 "kw": {"steps": STEPS, "seq": SEQ, "batch": BATCH,
                        "mesh": [2, 4], "overrides": {"dtype": "bfloat16"}}})
    return run_reference(jobs, host_devices=8)


def _guarded(**flags):
    return qtrain.QuantConfig(rounding="nearest", guards=GuardConfig(),
                              **flags)


def _check_guarded(hist, want):
    """Health words, skips, trips, degraded flags and formats equal; the
    losses within ``LOSS_RTOL``."""
    for k in GUARD_KEYS + FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k]),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("drill", list(DRILLS))
def test_guarded_drill_matches_reference_sharded_step(ref, drill, shape):
    cfg = _cfg()
    tag = _tag(drill, shape)
    mesh = StackedMesh(shape, ("data", "model"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hist, _ = _run(cfg, mesh, _ref_params(ref, cfg, f"{tag}/params/"),
                       qcfg=_guarded(**_flags(drill, shape)),
                       faults=FaultPlan(**DRILLS[drill][0]))
    # the fallback's warnings, word for word (none on a data axis of 1)
    assert [str(w.message) for w in caught] == json.loads(
        str(ref[f"{tag}/sharded/warnings"]))
    want = {k: list(ref[f"{tag}/sharded/hist/{k}"]) for k in hist}
    _check_guarded(hist, want)
    if drill == "nan":
        assert hist["health"] == [0, NAN_SKIP, 0]
        assert hist["skipped"] == [0, 1, 1]
    else:
        # the storm lasts 4 steps: each spikes the norm and is skipped,
        # and the trip degrades the (fallen-back) gradient wire's domain
        assert hist["skipped"] == [0, 1, 2] and hist["degraded"][1] == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_guarded_nan_step_runs_placed_like_unsharded(
        arch, one_thread):
    """Each family's guarded NaN drill at (2, 4) against its unsharded
    guarded step (a MoE model's under the mesh's binding, so that both
    take the all-to-all): the same health words, skips and formats, the
    losses within ``LOSS_RTOL``."""
    cfg = _cfg(arch)
    extras = _batch_extras(cfg)
    mesh = StackedMesh((2, 4), ("data", "model"))
    kw = dict(qcfg=_guarded(), faults=FaultPlan(nan_grads_at=1),
              extras=extras)
    with (axis_rules(mesh, LogicalRules()) if cfg.n_experts
          else contextlib.nullcontext()):
        want, _ = _run(cfg, None, **kw)
    got, _ = _run(cfg, mesh, **kw)
    _check_guarded(got, want)
    assert got["health"] == [0, NAN_SKIP, 0]


# ---------------------------------------------------------------------------
# the signals on placed trees
# ---------------------------------------------------------------------------

def _placed_grads(mesh, seed=3):
    """The smoke llama's parameter tree, whole and placed over ``mesh``, as
    a stand-in for a gradient tree: the holders of a block replicated over
    an axis share one tensor, as ``_reduce_replicated`` hands them out."""
    cfg = _cfg()
    params = init_params(registry(cfg.family).model_defs(cfg), "cpu",
                         torch.Generator().manual_seed(seed))
    return params, place(params, specs.param_shardings(
        cfg, mesh, LogicalRules()), mesh)


def test_a_nan_in_one_rank_block_is_bad_on_every_rank():
    mesh = StackedMesh((2, 4), ("data", "model"))
    _, grads = _placed_grads(mesh)
    flags = qtrain._placed_nonfinite(grads, mesh)
    assert [float(f) for f in flags] == [0.0] * 8
    wq = grads["layers"]["attn"]["wq"]        # split over data and model
    assert len(wq.distinct()) == 8
    for r in range(8):
        saved = wq.blocks[r].clone()
        wq.blocks[r].view(-1)[5] = float("nan" if r % 2 else "inf")
        flags = qtrain._placed_nonfinite(grads, mesh)
        assert [float(f) for f in flags] == [1.0] * 8, r
        wq.blocks[r].copy_(saved)


def test_the_storm_hits_a_shared_block_once():
    """``final_norm`` is replicated on all 8 ranks of a stacked (2, 4)
    mesh (one tensor), ``wq`` split 8 ways: after the storm each leaf is
    the whole gradient times ``storm_scale`` exactly once."""
    mesh = StackedMesh((2, 4), ("data", "model"))
    whole, grads = _placed_grads(mesh)
    assert len(grads["final_norm"].distinct()) == 1
    plan = FaultPlan(overflow_storm_at=2)
    qtrain._placed_grad_faults(plan, grads, 2)
    for (path, leaf), want in zip(tree_lib.leaves_with_path(grads),
                                  tree_lib.leaves(whole)):
        assert torch.equal(gather_placed(leaf), want * plan.storm_scale), path
    # a step past the storm's window leaves the tree as it is
    before = grads["final_norm"].blocks[0].clone()
    qtrain._placed_grad_faults(plan, grads, 2 + plan.storm_steps)
    assert torch.equal(grads["final_norm"].blocks[0], before)


class _NanGrad(torch.autograd.Function):
    """Identity forward; a NaN gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, float("nan"))


def _one_block_nan_step(cfg, mesh, block, at, counter):
    """The guarded placed step of ``cfg`` whose ``wq`` gradient is NaN in
    held block ``block`` (None: none) at step ``at`` only."""
    base = registry(cfg.family).placed_loss_fn(cfg)

    def loss_fn(params, batch, qctx):
        if block is not None and counter["step"] == at:
            attn = dict(params["layers"]["attn"])
            wq = attn["wq"]
            blocks = list(wq.blocks)
            blocks[block] = _NanGrad.apply(blocks[block])
            attn["wq"] = Placed(blocks, wq.spec, wq.mesh, wq.shape)
            params = {**params, "layers": {**params["layers"],
                                           "attn": attn}}
        return base(params, batch, qctx)

    return qtrain.make_placed_train_step(loss_fn, make_optimizer(SGDConfig()),
                                         _guarded(), mesh, LogicalRules())


def _held_copy(state):
    return [b.clone() for b in train_cli._held_blocks(state)]


def _one_block_nan_run(mesh, block, steps=3, at=1):
    """3 guarded placed steps with one block's NaN at step ``at``: the
    history and each held block before and after that step."""
    cfg = _cfg()
    counter = {"step": 0}
    step = _one_block_nan_step(cfg, mesh, block, at, counter)
    params = init_params(registry(cfg.family).model_defs(
        cfg, cfg.master_dtype()), "cpu", torch.Generator().manual_seed(0))
    opt = make_optimizer(SGDConfig())
    state = qtrain.TrainState.create(params, opt.init(params), _guarded(), 1)
    specs.place_train_state(cfg, state, mesh)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=SEQ,
                                         global_batch=BATCH, seed=0))
    hist, held = [], {}
    for i in range(steps):
        counter["step"] = i
        if i == at:
            held["before"] = _held_copy(state)
        state, m = step(state, data.batch(i))
        if i == at:
            held["after"] = _held_copy(state)
        hist.append({k: float(m[k]) for k in ("loss",) + GUARD_KEYS})
    return hist, held


def test_a_nan_in_one_rank_gradient_block_skips_the_placed_step(one_thread):
    """At (2, 4) the last rank's ``wq`` block alone gets a NaN gradient at
    step 1: the step is skipped (every held parameter and momentum block
    bit-equal across it) and step 2 updates again."""
    hist, held = _one_block_nan_run(StackedMesh((2, 4), ("data", "model")),
                                    block=7)
    assert [int(h["health"]) for h in hist] == [0, NAN_SKIP, 0]
    assert all(torch.equal(a, b) for a, b in zip(held["before"],
                                                 held["after"]))
    assert np.isfinite([h["loss"] for h in hist]).all()


# ---------------------------------------------------------------------------
# through the CLI: the rollback ring and a guarded checkpoint
# ---------------------------------------------------------------------------

def _argv(*extra, steps="4"):
    return ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu",
            "--steps", steps, "--batch", str(BATCH), "--seq", str(SEQ),
            "--optimizer", "sgd", "--log-every", "1", *extra]


def test_placed_rollback_ring_restores_in_place(one_thread, capsys):
    """The ring drill of ``tests/test_torch_resilience.py`` (NaN gradients
    at step 5 without in-step guards, a ring of 2) on a stacked (2, 4)
    mesh: the unsharded ring run's rollbacks, its finite and nonfinite
    steps, its losses within ``LOSS_RTOL``, and the state after each
    rollback the snapshot's, in the same ``Placed`` blocks."""
    argv = ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu",
            "--steps", "10", "--batch", "2", "--seq", "16", "--optimizer",
            "sgd", "--inject-nan-at", "5", "--rollback-ring", "2",
            "--log-every", "2"]
    whole = train_cli.main(argv, cfg=_cfg())
    ids = {}

    def keep_ids(step, state):
        ids.setdefault("blocks", [id(b) for b in
                                  train_cli._held_blocks(state)])
        assert [id(b) for b in train_cli._held_blocks(state)] \
            == ids["blocks"]

    placed = train_cli.main(argv, cfg=_cfg(), on_step=keep_ids,
                            mesh=StackedMesh((2, 4), ("data", "model")))
    text = capsys.readouterr().out
    assert placed["rollbacks"] == whole["rollbacks"] >= 1
    assert text.count("ROLLBACK") == 2 * whole["rollbacks"]
    got = np.array([h["loss"] for h in placed["history"]])
    want = np.array([h["loss"] for h in whole["history"]])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=LOSS_RTOL)
    assert [h["step"] for h in placed["history"]] == \
        [h["step"] for h in whole["history"]]


def test_guarded_placed_checkpoint_resumes(tmp_path, one_thread):
    """Guarded, NaN at step 1, ``--grad-allreduce-bits 8 --zero-opt`` (both
    fall back on the (2, 4) mesh): 2 steps written to a checkpoint and
    resumed for 2 more give the straight 4-step run's steps 2-3 bit for
    bit, the guard's skip count carried; a guarded run resumes a
    checkpoint written without guards (the guard state starts fresh)."""
    mesh = lambda: StackedMesh((2, 4), ("data", "model"))
    flags = ("--guards", "--inject-nan-at", "1", "--grad-allreduce-bits",
             "8", "--zero-opt")
    with pytest.warns(UserWarning, match="pure data-parallel mesh"):
        straight = train_cli.main(_argv(*flags), cfg=_cfg(), mesh=mesh())
        train_cli.main(_argv(*flags, "--ckpt-dir", str(tmp_path / "g"),
                             steps="2"), cfg=_cfg(), mesh=mesh())
        resumed = train_cli.main(_argv(*flags, "--ckpt-dir",
                                       str(tmp_path / "g"), "--resume"),
                                 cfg=_cfg(), mesh=mesh())
    assert not (straight["wire_sync"] or straight["zero_opt"])
    assert straight["guards"] and resumed["resumed"]["step"] == 2
    drop = ("launches", "kernel_launches")
    strip = lambda hist: [{k: v for k, v in h.items() if k not in drop}
                          for h in hist]
    assert strip(resumed["history"]) == strip(straight["history"][2:])
    assert [h["skipped"] for h in resumed["history"]] == [1.0, 1.0]
    assert "il_wire_grads" in straight["history"][0]
    train_cli.main(_argv(steps="2", *("--ckpt-dir", str(tmp_path / "u"))),
                   cfg=_cfg(), mesh=mesh())
    out = train_cli.main(_argv("--guards", "--ckpt-dir", str(tmp_path / "u"),
                               "--resume"), cfg=_cfg(), mesh=mesh())
    assert out["resumed"]["step"] == 2
    assert [h["health"] for h in out["history"]] == [0.0, 0.0]


# ---------------------------------------------------------------------------
# over gloo, 2 processes
# ---------------------------------------------------------------------------

def _gloo_rank(rank, world, store_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
        # the NaN on process 1's wq block only
        hist, held = _one_block_nan_run(mesh, block=0 if rank == 1 else None)
        same = all(torch.equal(a, b) for a, b in zip(held["before"],
                                                     held["after"]))
        cli = {}
        # the CLI, guarded with the NaN drill and the wire flag; then the
        # ring drill (no in-step guards: the NaN reaches the parameters)
        for run, argv in (
                ("guarded", _argv("--guards", "--inject-nan-at", "1",
                                  "--grad-allreduce-bits", "8",
                                  "--rollback-ring", "2", steps="3")),
                ("ring", _argv("--inject-nan-at", "3", "--rollback-ring",
                               "2", "--log-every", "2", steps="6"))):
            out = train_cli.main(argv, cfg=_cfg(), mesh=mesh)
            cli[run] = {"rollbacks": out["rollbacks"], "history": [
                {k: v for k, v in h.items() if k != "kernel_launches"}
                for h in out["history"]]}
        torch.save({"hist": hist, "held_same": same, "cli": cli},
                   f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_gloo_nan_on_one_process_skips_on_both(tmp_path):
    world = 2
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, world, str(tmp_path / "store"),
                               str(tmp_path / "out")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    outs = [torch.load(f"{tmp_path / 'out'}.{r}") for r in range(world)]
    for o in outs:
        assert [int(h["health"]) for h in o["hist"]] == [0, NAN_SKIP, 0]
        assert o["held_same"]
        health = [int(h["health"]) for h in o["cli"]["guarded"]["history"]]
        assert health[1] & NAN_SKIP == NAN_SKIP and health[2] & NAN_SKIP == 0
        assert o["cli"]["ring"]["rollbacks"] >= 1
    assert outs[0]["hist"] == outs[1]["hist"]
    np.testing.assert_equal(outs[0]["cli"], outs[1]["cli"])   # NaN == NaN


# ---------------------------------------------------------------------------
# the placed bf16 step's activation statistics
# ---------------------------------------------------------------------------

def test_placed_bf16_statistics_within_the_reference_gap(ref, one_thread):
    """bf16 compute at (2, 4), 3 steps from the reference's parameters:
    the port's placed formats equal its unsharded step's and the
    reference's unsharded step's, and its E_a and R_a lie no further from
    its unsharded step's than the reference's sharded step's lie from the
    reference's unsharded step's.  Each placed program rounds its bf16
    partial sums where it puts them, and E_a, the error of the few
    activations near the grid's bottom, moves with them in both packages:
    at this size the reference's own sharded step reads E_a 1.8e-6 at
    step 1 where its unsharded step reads 2.5e-4, and takes fl_a 13 where
    its unsharded step takes 11."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    params = _ref_params(ref, cfg, "bf16/params/")
    keys = FMTS + ("loss", "E_a", "R_a")

    def run(mesh):
        q = qtrain.QuantConfig(rounding="nearest")
        opt = make_optimizer(SGDConfig())
        step = specs.build_train_step(cfg, q, opt, accum_steps=1, mesh=mesh)
        state = qtrain.TrainState.create(
            tree_lib.map_tree(torch.clone, params), opt.init(params), q, 1)
        if mesh is not None:
            specs.place_train_state(cfg, state, mesh)
        data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=SEQ,
                                             global_batch=BATCH, seed=0))
        hist = {k: [] for k in keys}
        for i in range(STEPS):
            state, m = step(state, data.batch(i))
            for k in keys:
                hist[k].append(float(m[k]))
        return {k: np.asarray(v) for k, v in hist.items()}

    whole = run(None)
    placed = run(StackedMesh((2, 4), ("data", "model")))
    ref_whole = {k: ref[f"bf16/whole/hist/{k}"] for k in keys}
    ref_placed = {k: ref[f"bf16/sharded/hist/{k}"] for k in keys}
    for k in FMTS:
        np.testing.assert_array_equal(placed[k], whole[k], err_msg=k)
        np.testing.assert_array_equal(placed[k], ref_whole[k], err_msg=k)
    for k in ("E_a", "R_a"):
        gap = np.abs(placed[k] - whole[k])
        ref_gap = np.abs(ref_placed[k] - ref_whole[k])
        assert (gap <= ref_gap).all(), (k, gap, ref_gap)
