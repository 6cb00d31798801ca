"""The health guards, the wire's fp32 fallback and the fault drills.

Each row of the reference's failure-mode matrix that the port arms
(``src/repro/resilience/README.md``; the port's own README beside
``repro_torch/resilience`` maps every row to its test here):

* ``health_flags``; ``update_guard`` held against the reference's on the
  same inputs (clean, NaN loss, NaN gradients, spike, both storm triggers,
  a nonfinite overflow rate, the rail and ratchet counters, the cooldown).
* Armed and idle, the guards are transparent: the guarded step is bit-equal
  to the guard-free one at ``bits=None``, nearest@8 and stochastic@8
  (LeNet over 8 stacked ranks, as the reference's test runs it).
* NaN gradients -> skip (params, optimizer and DPS state held bit for bit)
  -> degrade -> re-arm after the cooldown; an overflow storm -> degrade ->
  recover; a wire bit flip -> spike detected and skipped, the NaN guard
  silent.
* The fp32 fallback's mean against the reference's ``pmean``: bit-equal at
  n = 2, within ``F32_MEAN_RTOL`` at n = 4.
* SIGTERM pre-emption -> corrupt -> resume through the CLI in a subprocess
  with a real signal; the rollback ring; ``--fail-at`` and the watchdog
  exit 17 with a checkpoint.
* Over gloo, 2 processes: a NaN on one rank skips and degrades both.
* What the port leaves out raises: guards or faults with ZeRO-1 or the
  overlapped wire, a wire flip outside the monolithic wire.
"""

import math
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import flatten_tree, latest_step
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DpsBundle, FlexState
from repro_torch.data import MNISTLike, TokenStream, TokenStreamConfig
from repro_torch.dist import F32TreeMean, ProcessGroupTransport, StackedTransport
from repro_torch.launch import train as train_cli
from repro_torch.models import lenet, registry, transformer
from repro_torch.models.common import init_params
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.resilience import (
    FaultPlan, GuardConfig, HEALTH_DEGRADED, HEALTH_GRAD_SPIKE,
    HEALTH_GRADS_NONFINITE, HEALTH_LOSS_NONFINITE, HEALTH_OVERFLOW_STORM,
    HEALTH_SKIPPED, corrupt_checkpoint, guards as guards_lib, health_flags,
    init_guard_state, update_guard)
from test_torch_checkpoint import CFG
from test_torch_jaxref import REPO, one_thread, run_reference  # noqa: F401

# the fallback's mean over 4 ranks: the reference's all-reduce may add the
# four terms in another order than the port's rank order (1 ulp)
F32_MEAN_RTOL = 1e-6
GUARD_FIELDS = ("health", "trips", "skipped", "degraded", "cooldown",
                "overflow_ewma", "gnorm_ewma", "fl_rail", "il_ratchet",
                "prev_il")
G = 3


def _guard_case(**over):
    """Inputs of one ``update_guard`` case: a warm guard state over one
    3-group wire domain, the step's signals and the new wire state."""
    c = {"guard/health": np.int32(0), "guard/trips": np.int32(1),
         "guard/skipped": np.int32(2), "guard/degraded": np.array([0], np.int32),
         "guard/cooldown": np.array([0], np.int32),
         "guard/overflow_ewma": np.array([0.01], np.float32),
         "guard/gnorm_ewma": np.float32(2.0),
         "guard/fl_rail": np.array([0], np.int32),
         "guard/il_ratchet": np.array([0], np.int32),
         "guard/prev_il": np.array([3], np.int32),
         "loss": np.float32(2.5), "grads_bad": np.float32(0.0),
         "gnorm": np.float32(2.2), "wire_ov": np.array([0.01], np.float32),
         "dps/il": np.array([2, 3, 3], np.int32),
         "dps/fl": np.array([6, 5, 5], np.int32),
         "dps/max_ema": np.array([1.0, 3.0, 2.0], np.float32)}
    c.update(over)
    return c


UPDATE_CASES = {
    "clean": _guard_case(),
    "cold": _guard_case(**{"guard/gnorm_ewma": np.float32(0.0),
                           "gnorm": np.float32(1e9)}),
    "nan_loss": _guard_case(loss=np.float32(np.nan)),
    "nan_grads": _guard_case(grads_bad=np.float32(7.0),
                             gnorm=np.float32(np.nan)),
    "spike": _guard_case(gnorm=np.float32(40.0)),
    "storm_ewma": _guard_case(**{"guard/overflow_ewma":
                                 np.array([0.3], np.float32)}),
    "storm_hi": _guard_case(wire_ov=np.array([0.8], np.float32)),
    "ov_nonfinite": _guard_case(wire_ov=np.array([np.nan], np.float32)),
    "rail": _guard_case(**{"guard/fl_rail": np.array([7], np.int32),
                           "wire_ov": np.array([0.1], np.float32),
                           "dps/fl": np.array([6, 5, 6], np.int32)}),
    "ratchet": _guard_case(**{"guard/il_ratchet": np.array([7], np.int32),
                              "guard/prev_il": np.array([2], np.int32)}),
    "cooling": _guard_case(**{"guard/degraded": np.array([1], np.int32),
                              "guard/cooldown": np.array([2], np.int32)}),
    "rearm": _guard_case(**{"guard/degraded": np.array([1], np.int32),
                            "guard/cooldown": np.array([1], np.int32)}),
    "trip_while_degraded": _guard_case(
        loss=np.float32(np.inf), **{"guard/degraded": np.array([1], np.int32),
                                    "guard/cooldown": np.array([5], np.int32)}),
}


@pytest.fixture(scope="module")
def ref():
    arrays = {f"ug/{name}/{k}": v for name, case in UPDATE_CASES.items()
              for k, v in case.items()}
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (13,), "c": (2, 3, 4)}
    trees = {}
    for n in (2, 4):
        trees[n] = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
                     for k, s in shapes.items()} for _ in range(n)]
        for r, t in enumerate(trees[n]):
            arrays.update({f"f32/n{n}/r{r}/{k}": v for k, v in t.items()})
    out = run_reference([
        {"job": "update_guard", "tag": "ug",
         "kw": {"cases": {name: {"groups": G} for name in UPDATE_CASES}}},
        {"job": "f32_mean", "tag": "f32",
         "kw": {"cases": {f"n{n}": {"n": n} for n in (2, 4)}}},
    ], arrays, host_devices=4)
    return out, trees


def test_health_flags_decode():
    word = HEALTH_GRADS_NONFINITE | HEALTH_DEGRADED | HEALTH_SKIPPED
    assert health_flags(word) == ("grads-nonfinite", "degraded", "skipped")
    assert health_flags(0) == ()
    assert health_flags(255) == tuple(n for _, n in guards_lib._HEALTH_NAMES)


@pytest.mark.parametrize("name", sorted(UPDATE_CASES))
def test_update_guard_matches_the_reference(ref, name):
    out, _ = ref
    c = {k: torch.as_tensor(v) for k, v in UPDATE_CASES[name].items()}
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, wire_grads_groups=G)
    plan = qcfg.plan()
    dps = qtrain.init_dps_bundle(qcfg)
    dps = DpsBundle((n, FlexState(c["dps/il"], c["dps/fl"], c["dps/max_ema"])
                     if n == "wire_grads" else dps[n]) for n in dps.names())
    guard = guards_lib.GuardState(**{f: c["guard/" + f]
                                     for f in GUARD_FIELDS})
    new, ok, trip_any = update_guard(
        GuardConfig(), plan, guard, loss=c["loss"], grads_bad=c["grads_bad"],
        gnorm=c["gnorm"], wire_ov=c["wire_ov"], new_dps=dps)
    for f in GUARD_FIELDS:
        got = getattr(new, f).numpy()
        want = out[f"ug/{name}/{f}"]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert bool(ok) == bool(out[f"ug/{name}/ok"])
    assert bool(trip_any) == bool(out[f"ug/{name}/trip_any"])
    assert bool(ok) == bool(guards_lib.step_ok(
        GuardConfig(), guard, loss=c["loss"], grads_bad=c["grads_bad"],
        gnorm=c["gnorm"]))


def test_nonfinite_any_sees_nan_and_both_infinities():
    """The raw-gradient signal: one min/max reduction a leaf finds a NaN,
    +Inf or -Inf anywhere (fp32 and bf16 leaves, an empty leaf skipped)."""
    clean = {"a": torch.randn(4, 5), "b": torch.zeros(0),
             "c": torch.randn(3, dtype=torch.bfloat16)}
    assert float(guards_lib.nonfinite_any(clean)) == 0.0
    assert float(guards_lib.nonfinite_any({})) == 0.0
    for bad in (float("nan"), float("inf"), -float("inf")):
        for k in ("a", "c"):
            tree = {n: v.clone() for n, v in clean.items()}
            tree[k].view(-1)[1] = bad
            assert float(guards_lib.nonfinite_any(tree)) == 1.0, (k, bad)


@pytest.mark.parametrize("n", [2, 4])
def test_f32_fallback_mean_matches_the_reference_pmean(ref, n):
    out, trees = ref
    tr = StackedTransport(n)
    like = {k: torch.from_numpy(v) for k, v in trees[n][0].items()}
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, wire_grads_groups=3)
    fmts = qtrain.bundle_formats(qcfg, qtrain.init_dps_bundle(qcfg))
    sink = F32TreeMean(like, fmts, tr)
    for r in tr.ranks:
        tree = {k: torch.from_numpy(v.copy()) for k, v in trees[n][r].items()}
        sink.encode(r, tree)
        # the caller measures and drops each rank's gradients in place once
        # encoded: the sum must not alias them
        for v in tree.values():
            v.fill_(float("nan"))
    mean, stats = sink.finish()
    assert len(stats) == n and all(float(s.count.sum()) == 0 for s in stats)
    assert stats[0].count.shape == (3,)
    for k, v in mean.items():
        want = out[f"f32/n{n}/mean/{k}"]
        if n == 2:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, rtol=F32_MEAN_RTOL,
                                       err_msg=k)
    with pytest.raises(RuntimeError, match="encoded ranks"):
        F32TreeMean(like, fmts, tr).finish()


# ---------------------------------------------------------------------------
# the guarded step (LeNet over 8 stacked ranks, the reference test's set-up)
# ---------------------------------------------------------------------------

def _lenet_batch():
    b = MNISTLike(batch=64, seed=0, n_train=256, n_test=64).train_batch(0)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _lenet_run(steps, guards=None, faults=None, n=8, **qkw):
    """LeNet from ``init(0)`` for ``steps`` steps on one batch; returns the
    final state, each step's metrics, and the state flattened before and
    after every step."""
    params = lenet.init(0)
    qcfg = qtrain.QuantConfig(guards=guards, **qkw)
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(lenet.loss_fn, opt, qcfg,
                                  transport=StackedTransport(n),
                                  faults=faults)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    batch = _lenet_batch()
    hist, flats = [], [flatten_tree(state)]
    for _ in range(steps):
        state, m = step(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
        flats.append(flatten_tree(state))
    return state, hist, flats


TRANSPARENCY = {
    "bits=None": dict(),
    "nearest@8": dict(grad_allreduce_bits=8, rounding="nearest"),
    "stochastic@8": dict(grad_allreduce_bits=8),
}


@pytest.mark.parametrize("name", sorted(TRANSPARENCY))
def test_armed_idle_guards_are_bit_transparent(one_thread, name):
    _, h0, f0 = _lenet_run(3, **TRANSPARENCY[name])
    _, hg, fg = _lenet_run(3, GuardConfig(), **TRANSPARENCY[name])
    for a, b in zip(h0, hg):
        assert {k: b[k] for k in a} == a
        assert b["health"] == b["skipped"] == b["trips"] == b["degraded"] == 0
    for k, v in f0[-1].items():
        np.testing.assert_array_equal(fg[-1][k], v, err_msg=k)


def _held(before, after):
    """Params, optimizer and DPS state bit-equal across a skipped step."""
    for k, v in before.items():
        if k.startswith((".params", ".opt_state", ".dps")):
            np.testing.assert_array_equal(after[k], v, err_msg=k)


def test_nan_gradients_skip_degrade_and_rearm(one_thread):
    s, hist, flats = _lenet_run(8, GuardConfig(cooldown=3),
                                FaultPlan(nan_grads_at=2),
                                grad_allreduce_bits=8)
    h2 = int(hist[2]["health"])
    assert h2 & HEALTH_GRADS_NONFINITE and h2 & HEALTH_SKIPPED, hist
    assert not h2 & HEALTH_LOSS_NONFINITE       # the forward was clean
    # the params/opt/DPS update of the poisoned step is skipped bit for bit
    # (the compute grads domain then widens by one IL bit)
    _held({k: v for k, v in flats[2].items() if k != ".dps/grads/.il"},
          flats[3])
    assert int(flats[3][".dps/grads/.il"]) == int(flats[2][".dps/grads/.il"]) + 1
    assert [h["skipped"] for h in hist] == [0, 0, 1, 1, 1, 1, 1, 1]
    assert hist[2]["degraded"] == hist[3]["degraded"] == 1   # fp32 next
    assert hist[3]["E_wire"] == 0.0                          # ran fp32
    assert hist[7]["degraded"] == 0                          # re-armed
    assert int(s.guard.trips) == 1
    assert all(np.isfinite(v).all() for k, v in flats[-1].items()
               if k.startswith(".params"))


def _lm_run(steps, guards=None, faults=None):
    """The smoke LM over the int8 wire on 2 stacked ranks, per-layer
    formats: ``(state, metrics a step)``."""
    params = init_params(transformer.model_defs(CFG, CFG.master_dtype()),
                         "cpu", torch.Generator().manual_seed(0))
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8,
                              guards=guards).with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=StackedTransport(2),
                                  faults=faults)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=8,
                                         global_batch=4, seed=0))
    hist = []
    for i in range(steps):
        state, m = step(state, data.batch(i))
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


def test_overflow_storm_degrades_and_recovers(one_thread):
    """The smoke LM's dense gradients at the fault plan's default scale
    (2^18, the CLI's ``--inject-storm-at``): the instantaneous overflow
    rate crosses 0.75.  (LeNet's pooled gradients are half zeros, whose
    rate stays under it: there the spike guard catches the storm.)"""
    _, clean = _lm_run(12, GuardConfig(cooldown=3))
    s, hist = _lm_run(12, GuardConfig(cooldown=3),
                      FaultPlan(overflow_storm_at=2, storm_steps=2))
    assert any(int(h["health"]) & HEALTH_OVERFLOW_STORM for h in hist[2:5])
    assert any(h["degraded"] for h in hist[2:8]), hist
    assert hist[-1]["degraded"] == 0
    assert int(s.guard.trips) >= 1
    assert all(bool(torch.isfinite(l).all())
               for l in tree_lib.leaves(s.params))
    lf, l0 = hist[-1]["loss"], clean[-1]["loss"]
    assert math.isfinite(lf) and lf < 2.0 * l0 + 1.0, (lf, l0)


def test_wire_bit_flip_is_caught_as_a_spike_and_skipped(one_thread):
    s, hist, flats = _lenet_run(8, GuardConfig(cooldown=2),
                                FaultPlan(wire_flip_at=3),
                                grad_allreduce_bits=8)
    h3 = int(hist[3]["health"])
    assert h3 & HEALTH_GRAD_SPIKE and h3 & HEALTH_SKIPPED, hist
    # the wire cannot carry NaN: the NaN guard must not fire
    assert not h3 & (HEALTH_GRADS_NONFINITE | HEALTH_LOSS_NONFINITE)
    assert all(int(h["health"]) == 0 for h in hist[:3])
    _held({k: v for k, v in flats[3].items() if k != ".dps/grads/.il"},
          flats[4])
    assert hist[4]["degraded"] == 1 and hist[7]["degraded"] == 0
    assert all(np.isfinite(v).all() for k, v in flats[-1].items()
               if k.startswith(".params"))


def test_replicated_step_guards_skip_a_nan_step(one_thread):
    """Without the wire (no wire domain, D = 0) the monitor still skips."""
    _, hist, flats = _lenet_run(3, GuardConfig(), FaultPlan(nan_grads_at=1))
    assert int(hist[1]["health"]) == HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED
    assert [h["degraded"] for h in hist] == [0, 0, 0]
    _held({k: v for k, v in flats[1].items() if k != ".dps/grads/.il"},
          flats[2])


# ---------------------------------------------------------------------------
# the CLI drills
# ---------------------------------------------------------------------------

def _cli_args(d, *extra, steps=8):
    return ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--batch", "4", "--seq", "8",
            "--optimizer", "sgd", "--grad-allreduce-bits", "8",
            "--data-ranks", "2", "--guards", "--ckpt-dir", str(d),
            "--ckpt-every", "2", "--log-every", "2", *extra]


def _train_subprocess(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=600)


def test_sigterm_preemption_checkpoints_and_resumes_past_corruption(
        tmp_path):
    out = _train_subprocess(_cli_args(tmp_path, "--sigterm-at", "5"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PREEMPTED: signal 15 (checkpointed at step 5)" in out.stdout
    assert latest_step(str(tmp_path)) == 5
    # disk rot on top of the pre-emption: resume falls back to the newest
    # good checkpoint and still finishes
    corrupt_checkpoint(str(tmp_path), 5, mode="truncate")
    assert latest_step(str(tmp_path)) == 4
    out = _train_subprocess(_cli_args(tmp_path, "--resume"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resumed from step 4 (data cursor 4)" in out.stdout
    assert "final_loss" in out.stdout
    assert latest_step(str(tmp_path)) == 8


def test_rollback_ring_restores_healthy_state(one_thread, capsys):
    """NaN gradients at step 5 with no in-step guards: the parameters go
    NaN, the drained window turns nonfinite, the ring rolls back to the
    step-5 snapshot and replays; every replay re-fires the step-keyed
    fault, and each replayed window's step-5 loss is finite again (the
    restored parameters).  The cap of 8 bounds the loop and the run
    completes."""
    out = train_cli.main([
        "--arch", "llama3_2_3b", "--smoke", "--device", "cpu", "--steps",
        "10", "--batch", "2", "--seq", "16", "--optimizer", "sgd",
        "--inject-nan-at", "5", "--rollback-ring", "2", "--log-every", "2"])
    text = capsys.readouterr().out
    n_rb = text.count("ROLLBACK")
    assert 1 <= n_rb <= 8 and out["rollbacks"] == n_rb, text
    assert "resuming from step 5 with wire degraded" in text
    losses = [h["loss"] for h in out["history"]]
    first_bad = next(i for i, v in enumerate(losses) if not np.isfinite(v))
    assert sum(np.isfinite(losses[first_bad:])) >= n_rb, (n_rb, losses)
    assert not np.isfinite(losses[-1])


def test_fail_at_and_the_watchdog_exit_17_with_a_checkpoint(tmp_path,
                                                           capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.main(_cli_args(tmp_path / "f", "--fail-at", "3"))
    assert e.value.code == 17
    assert "ABORT: injected failure at step 3 (checkpointed at step 3)" \
        in capsys.readouterr().out
    assert latest_step(str(tmp_path / "f")) == 3
    with pytest.raises(SystemExit) as e:
        train_cli.main(_cli_args(tmp_path / "w", "--step-timeout", "1e-9"))
    assert e.value.code == 17
    assert "straggler watchdog" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "w")) == 2


# ---------------------------------------------------------------------------
# every rank takes the same branch (gloo, 2 processes)
# ---------------------------------------------------------------------------

def _gloo_guard_rank(rank, world, store_path, out_path):
    """One process: the guarded wire step of the smoke LM over gloo, the
    loss (and so the gradients) NaN on rank 1 alone at step 1."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        base = registry(CFG.family).loss_fn(CFG)
        at = {"step": 0}

        def loss_fn(params, batch, qctx):
            loss, aux = base(params, batch, qctx)
            if rank == 1 and at["step"] == 1:
                loss = loss * float("nan")
            return loss, aux

        params = init_params(transformer.model_defs(CFG, CFG.master_dtype()),
                             "cpu", torch.Generator().manual_seed(0))
        qcfg = qtrain.QuantConfig(grad_allreduce_bits=8,
                                  guards=GuardConfig(cooldown=1),
                                  rounding="nearest").with_per_layer_wire(
                                      params)
        opt = make_optimizer(SGDConfig())
        step = qtrain.make_train_step(loss_fn, opt, qcfg,
                                      transport=ProcessGroupTransport())
        state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
        data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=8,
                                             global_batch=4, seed=0))
        hist, flats = [], [flatten_tree(state)]
        for i in range(3):
            at["step"] = i
            state, m = step(state, data.batch(i))
            hist.append({k: float(v) for k, v in m.items()})
            flats.append(flatten_tree(state))
        torch.save({"hist": hist, "flats": flats}, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_a_nan_on_one_rank_skips_and_degrades_every_rank(tmp_path):
    world = 2
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_guard_rank,
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
    runs = [torch.load(tmp_path / f"out.{r}", weights_only=False)
            for r in range(world)]
    for run in runs:
        h = run["hist"]
        assert int(h[1]["health"]) & (HEALTH_LOSS_NONFINITE
                                      | HEALTH_GRADS_NONFINITE
                                      | HEALTH_SKIPPED) == (
            HEALTH_LOSS_NONFINITE | HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED)
        assert h[1]["degraded"] == 1 and h[2]["E_wire"] == 0.0
        _held({k: v for k, v in run["flats"][1].items()
               if k != ".dps/grads/.il"}, run["flats"][2])
    # one decision, one state: the ranks agree bit for bit
    np.testing.assert_equal(runs[0]["hist"], runs[1]["hist"])
    for k, v in runs[0]["flats"][-1].items():
        np.testing.assert_array_equal(runs[1]["flats"][-1][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# what the port leaves out raises
# ---------------------------------------------------------------------------

def _mlp_loss(params, batch, qctx=None):
    h = torch.tanh(batch["x"] @ params["w1"])
    return torch.mean((h @ params["w2"] - batch["y"]) ** 2), {}


@pytest.mark.parametrize("kw,faults", [
    (dict(zero_opt_shards=2, guards=GuardConfig()), None),
    (dict(wire_overlap=True, guards=GuardConfig()), None),
    (dict(zero_opt_shards=2), FaultPlan(nan_grads_at=1)),
    (dict(wire_overlap=True), FaultPlan(overflow_storm_at=1)),
])
def test_guards_and_faults_with_zero_or_overlap_raise(kw, faults):
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, **kw)
    with pytest.raises(NotImplementedError, match="Queue 1, item 1"):
        qtrain.make_train_step(_mlp_loss, make_optimizer(SGDConfig()), qcfg,
                               transport=StackedTransport(2), faults=faults)


@pytest.mark.parametrize("kw,n", [(dict(), 2), (dict(grad_allreduce_bits=8), 1),
                                  (dict(grad_allreduce_bits=8,
                                        wire_overlap=True), 2)])
def test_a_wire_flip_outside_the_monolithic_wire_raises(kw, n):
    with pytest.raises(ValueError, match="wire_flip_at"):
        qtrain.make_train_step(_mlp_loss, make_optimizer(SGDConfig()),
                               qtrain.QuantConfig(**kw),
                               transport=StackedTransport(n),
                               faults=FaultPlan(wire_flip_at=1))


def test_guard_state_has_one_slot_per_wire_domain():
    plan = qtrain.QuantConfig(grad_allreduce_bits=8, zero_opt_shards=2).plan()
    assert guards_lib.wire_domains(plan) == ("wire_grads", "wire_params")
    g = init_guard_state(plan)
    assert g.degraded.shape == (2,) and g.prev_il.tolist() == [6, 2]
    assert init_guard_state(qtrain.QuantConfig().plan()).degraded.shape == (0,)
