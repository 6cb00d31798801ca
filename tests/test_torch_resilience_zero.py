"""The health guards and the fault drills on ZeRO-1 and the overlapped wire,
and ZeRO-1 checkpoints under ``torchrun``.

* Guarded ZeRO against the reference (2 ranks, nearest rounding): the
  fully quantized two-layer MLP of ``job_zero_mlp_train`` (its params leg
  on the int8 wire) on the plain layout (one global wire format), the
  aligned layout (per-layer formats) and the aligned layout with the
  overlapped wire, each with NaN gradients at step 1 and with an overflow
  storm at steps 1-2; the smoke LM (its params leg in fp32) aligned and
  overlapped with NaN gradients.  Step by step the health word, the skip,
  trip and degraded counters, the per-domain ``degraded`` vector and every
  domain's formats are equal; the parameters and the optimizer state are
  held to the unguarded ZeRO parity tests' tolerances.  With the overlap
  (several buckets) the reference's fp32 fallback is not the exact mean on
  each owner's shard: its ``psum_scatter(part.flatten(grads))`` hands rank
  ``j`` the ``j``-th contiguous slice of the bucket-major flat vector,
  where its ``part.shard`` is rank ``j``'s chunk of every bucket.  The port
  gives each owner its own segments; so an overlapped run is held to the
  reference up to and including its degraded step (whose own metrics do
  not read the misplaced update), and bit for bit to the port's aligned
  run (one bucket, where the reference's fallback is right) throughout.
* The params leg trips on its own: ``wire_params`` pinned to ⟨1, 7⟩ under
  weights of magnitude above 1 overflows it; the next step's all-gather is
  fp32 (no int8 all-gather runs) and equals the reference's.
* Armed and idle, the guards change nothing on any body: the ZeRO step
  without the wire, the plain and the aligned ZeRO wire step, ZeRO with
  the overlap, and the overlapped wire without ZeRO — every metric and the
  whole state bit-equal to the unguarded run.
* Faults applied leaf by leaf in the overlap's backward hooks equal the
  tree-wise ones: after a NaN step the overlapped and the monolithic wire
  step (and ZeRO with and without the overlap) hold equal states.
* ZeRO-1 checkpoints under ``torchrun --nproc-per-node 2`` over gloo: a run
  pre-empted at step 2 and resumed equals the straight run, and its
  checkpoint's arrays equal the stacked ``--data-ranks 2`` run's.
* ``convert.zero_opt_state_to_jax`` inverts ``zero_opt_state_from_jax``,
  and the reference restores a port checkpoint written with it and takes
  the port's next step.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import flatten_tree
from repro_torch.checkpoint.ckpt import save_flat
from repro_torch.convert import (params_from_jax, zero_opt_state_from_jax,
                                 zero_opt_state_to_jax)
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DPSHyper
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.dist import StackedTransport
from repro_torch.dist import overlap as overlap_lib
from repro_torch.models import registry
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.resilience import (FaultPlan, GuardConfig, HEALTH_DEGRADED,
                                    HEALTH_GRADS_NONFINITE,
                                    HEALTH_OVERFLOW_STORM, HEALTH_SKIPPED)
from test_torch_jaxref import (GUARDED_ZERO_METRICS, NARROW_WIRE_PARAMS,
                               REPO, one_thread, run_reference,  # noqa: F401
                               unflatten)
from test_torch_wire_train import (CFG, LOSS_RTOL, PARAM_DIFF_FRACTION,
                                   PARAM_DIFF_STEPS, _smoke_params)
from test_torch_zero import (MLP_ARRAYS, MLP_E_WIRE_RTOL, MLP_LOSS_RTOL,
                             MLP_PARAM_DIFF_FRACTION, MLP_SHAPES, _mlp_loss)

N = 2
MLP_STEPS = 5
# The LM: the skip (step 1) and the fp32 fallback (step 2).  The fallback
# carries the two frameworks' raw fp32 gradients, whose last bits differ
# (no wire grid hides them), so the policy-excluded norm scales end a few
# ulps apart: 28 of 94,528 elements after step 2, by under 2^-10 of a
# weight grid step.  One more int8 step carries that to 54 elements (one
# grid step), past the 5e-4 the wire tests state for 3 steps; the re-armed
# int8 step is held on the MLP, 5 steps.
LM_STEPS = 3
FLAGS = ("health", "skipped", "trips", "degraded")
FORMATS = tuple(k for k in GUARDED_ZERO_METRICS
                if k.startswith(("il_", "fl_")))
# the LM's E_wire: the wire step's tolerance (test_torch_wire_train)
LM_E_WIRE_RTOL = 1e-4
# The momenta the steps end with, reference vs port, flat, as the norm of
# the difference over the norm.  The int8 steps' decoded shards sit on the
# wire grid, equal wherever the two frameworks' gradients fall in one grid
# cell; the fp32 fallback's are the raw gradients' exact mean, whose last
# bits differ between the frameworks.  The MLP snaps them onto its gradient
# grid (every leaf quantized): a few cross a grid boundary; measured 1.4e-6
# at worst.  The LM's (its params leg fp32, so no optimizer-input snap)
# carry its bf16 products' differences whole: measured 1.6e-4.
MU_NORM_RTOL = {"mlp": 1e-5, "lm": 1e-3}
# E_wire of a step whose gradient leg ran the fp32 fallback, on the MLP:
# only its int8 params leg's statistics, of parameters updated with the
# exact mean of the raw gradients (their last bits differ between the
# frameworks), so a parameter can land on the other side of a rounding
# boundary of the wire_params grid, and one element of 600 moves the mean
# relative error by about a percent.  Measured: 1.4e-2 and 3.8e-2 relative
# (the overflow storm's fallback steps); every other step is held to
# MLP_E_WIRE_RTOL.
E_WIRE_FALLBACK_RTOL = 5e-2
# A per-layer format's mean over G integer rows: the reference multiplies
# by 1/G where the port divides (one ulp apart); a row one bit off moves
# it by 1/G.
FORMAT_MEAN_RTOL = 2.0 ** -20

NAN = {"nan_grads_at": 1}
STORM = {"overflow_storm_at": 1, "storm_steps": 2}
# case: (model, layout, faults, steps)
CASES = {
    f"mlp_{layout}_{fname}": ("mlp", layout, faults, MLP_STEPS)
    for layout in ("plain", "aligned", "overlap")
    for fname, faults in (("nan", NAN), ("storm", STORM))}
CASES.update({f"lm_{layout}_nan": ("lm", layout, NAN, LM_STEPS)
              for layout in ("aligned", "overlap")})
BUCKET_ELEMS = {"mlp": 300, "lm": 10000}
NARROW_STEPS = 4


def _narrow_arrays():
    """The MLP with every weight of magnitude above 1: the params leg's
    ⟨1, 7⟩ clips all of them."""
    out = dict(MLP_ARRAYS)
    for k in MLP_SHAPES:
        v = MLP_ARRAYS[f"params/{k}"]
        out[f"params/{k}"] = (np.sign(v) * (1.5 + np.abs(v))).astype(
            np.float32)
    return out


NARROW_ARRAYS = _narrow_arrays()


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for name, (model, layout, faults, steps) in CASES.items():
        jobs.append({"job": "guarded_zero_train", "tag": name, "kw": {
            "steps": steps, "n": N, "model": model, "layout": layout,
            "faults": faults, "bucket_elems": BUCKET_ELEMS[model]}})
        if model == "mlp":
            arrays.update({f"{name}/{k}": v for k, v in MLP_ARRAYS.items()})
    jobs.append({"job": "guarded_zero_train", "tag": "narrow", "kw": {
        "steps": NARROW_STEPS, "n": N, "model": "mlp", "layout": "aligned",
        "narrow_params": True}})
    arrays.update({f"narrow/{k}": v for k, v in NARROW_ARRAYS.items()})
    return run_reference(jobs, arrays, host_devices=N)


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

def _qcfg(params, layout, *, guards=True, narrow=False, rounding="nearest",
          zero=True, wire=True, bucket_elems=300):
    kw = dict(rounding=rounding)
    if wire:
        kw["grad_allreduce_bits"] = 8
    if zero:
        kw["zero_opt_shards"] = N
    if guards:
        kw["guards"] = GuardConfig(cooldown=1)
    if layout == "overlap":
        kw.update(wire_overlap=True, wire_bucket_elems=bucket_elems)
    if narrow:
        kw["hyper_wire_params"] = DPSHyper(**NARROW_WIRE_PARAMS)
    qcfg = qtrain.QuantConfig(**kw)
    return qcfg.with_per_layer_wire(params) if layout != "plain" else qcfg


def _model(model, arrays=None, ref_params=None):
    """(loss_fn, params, batch_at, optimizer) of the MLP or the smoke LM."""
    if model == "mlp":
        arrays = MLP_ARRAYS if arrays is None else arrays
        params = {k: torch.from_numpy(arrays[f"params/{k}"].copy())
                  for k in MLP_SHAPES}
        batch = {k: torch.from_numpy(arrays[k]) for k in ("x", "y")}
        return (_mlp_loss, params, lambda i: batch,
                make_optimizer(SGDConfig(lr=0.05, schedule="const")))
    params = (_smoke_params() if ref_params is None
              else params_from_jax(ref_params, CFG, "cpu", training=True))
    data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=8,
                                         global_batch=2 * N, seed=0))
    return (registry(CFG.family).loss_fn(CFG), params, data.batch,
            make_optimizer(SGDConfig()))


def _run(model, layout, steps, *, faults=None, arrays=None, ref_params=None,
         on_step=None, **qkw):
    """Run ``steps`` steps on ``StackedTransport(2)``; returns the final
    state, each step's metrics, each step's ``degraded`` vector (guards
    armed) and the step function."""
    loss_fn, params, batch_at, opt = _model(model, arrays, ref_params)
    qkw.setdefault("bucket_elems", BUCKET_ELEMS[model])
    qcfg = _qcfg(params, layout, **qkw)
    tr = StackedTransport(N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the LM's fp32 params leg
        step = qtrain.make_train_step(
            loss_fn, opt, qcfg, transport=tr,
            faults=FaultPlan(**faults) if faults else None)
        opt_state = (qtrain.zero_opt_state(opt, params, tr, qcfg)
                     if step.zero_opt_active else opt.init(params))
        state = qtrain.TrainState.create(params, opt_state, qcfg, 1)
        hist, deg = [], []
        for i in range(steps):
            if on_step is not None:
                on_step(i)
            state, m = step(state, batch_at(i))
            hist.append({k: float(v) for k, v in m.items()})
            if state.guard is not None:
                deg.append(state.guard.degraded.tolist())
    return state, hist, deg, step


def _check_params(got, want, fl, steps, fraction):
    """Every element within ``steps`` grid steps of ``2^-fl``, at most a
    ``fraction`` of them differing at all."""
    grid = 2.0 ** -fl
    total = differ = 0
    for (path, g), (_, w) in zip(tree_lib.leaves_with_path(got),
                                 tree_lib.leaves_with_path(want)):
        gap = (g - w).abs()
        assert float(gap.max()) <= steps * grid, path
        total, differ = total + g.numel(), differ + int((gap > 0).sum())
    assert differ <= fraction * total, (differ, total)
    return differ


def _check_against_reference(ref, tag, model, state, hist, deg, qcfg,
                             upto=None):
    """Steps ``[0, upto)`` (all) against the reference's; without
    ``upto`` the final guard state, parameters and momenta too."""
    final = upto is None
    upto = upto or len(hist)
    for k in FLAGS:
        np.testing.assert_array_equal([h[k] for h in hist[:upto]],
                                      ref[f"{tag}/hist/{k}"][:upto], err_msg=k)
    for k in FORMATS:
        np.testing.assert_allclose([h[k] for h in hist[:upto]],
                                   ref[f"{tag}/hist/{k}"][:upto],
                                   rtol=FORMAT_MEAN_RTOL, err_msg=k)
    np.testing.assert_array_equal(np.asarray(deg[:upto]),
                                  ref[f"{tag}/degraded_vec"][:upto])
    np.testing.assert_array_equal([h["R_wire"] for h in hist[:upto]],
                                  ref[f"{tag}/hist/R_wire"][:upto])
    loss_rtol, e_rtol = ((MLP_LOSS_RTOL, MLP_E_WIRE_RTOL) if model == "mlp"
                         else (LOSS_RTOL, LM_E_WIRE_RTOL))
    np.testing.assert_allclose([h["loss"] for h in hist[:upto]],
                               ref[f"{tag}/hist/loss"][:upto], rtol=loss_rtol)
    for i in range(upto):
        fallback = i > 0 and deg[i - 1][0] == 1
        np.testing.assert_allclose(
            hist[i]["E_wire"], ref[f"{tag}/hist/E_wire"][i],
            rtol=E_WIRE_FALLBACK_RTOL if fallback else e_rtol,
            err_msg=f"E_wire, step {i}")
    if not final:
        return
    for f in ("health", "trips", "skipped", "degraded", "cooldown"):
        np.testing.assert_array_equal(getattr(state.guard, f).numpy(),
                                      ref[f"{tag}/guard/{f}"], err_msg=f)
    np.testing.assert_allclose(state.guard.overflow_ewma.numpy(),
                               ref[f"{tag}/guard/overflow_ewma"], rtol=1e-5)
    if model == "mlp":
        final = {k: torch.from_numpy(ref[f"{tag}/final/{k}"])
                 for k in MLP_SHAPES}
        _check_params(state.params, final, hist[-1]["fl_wire_params"], 2,
                      MLP_PARAM_DIFF_FRACTION)
    else:
        final = params_from_jax(unflatten(ref, f"{tag}/final/"), CFG, "cpu",
                                training=True)
        _check_params(state.params, final, hist[-1]["fl_w"],
                      PARAM_DIFF_STEPS, PARAM_DIFF_FRACTION)
    mu = zero_opt_state_to_jax(state.opt_state, state.params, qcfg, N)["mu"]
    want = ref[f"{tag}/opt/mu"]
    assert mu.shape == want.shape
    rel = float(np.linalg.norm(mu - want) / np.linalg.norm(want))
    assert rel <= MU_NORM_RTOL[model], rel


@pytest.mark.parametrize("name", sorted(CASES))
def test_guarded_zero_matches_the_reference(ref, name):
    model, layout, faults, steps = CASES[name]
    ref_params = (unflatten(ref, f"{name}/params/") if model == "lm"
                  else None)
    state, hist, deg, step = _run(model, layout, steps, faults=faults,
                                  ref_params=ref_params)
    assert step.zero_opt_active and step.guards_active
    assert step.zero_groupaligned_active == (layout != "plain")
    assert step.wire_overlap_active == (layout == "overlap")
    h1 = int(hist[1]["health"])
    if faults is NAN:
        assert h1 & (HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED)
    else:
        assert h1 & HEALTH_OVERFLOW_STORM and h1 & HEALTH_DEGRADED
    assert hist[1]["degraded"] == 1
    if model == "lm":        # both legs fp32 on the degraded step
        assert hist[2]["E_wire"] == 0.0
    if layout != "overlap":
        _check_against_reference(ref, name, model, state, hist, deg,
                                 step.qcfg)
        return
    # against the reference up to the update its fallback misplaces (the
    # MLP's int8 params leg encodes that update in step 2's E_wire), then
    # bit for bit against the port's aligned run (the module docstring)
    _check_against_reference(ref, name, model, state, hist, deg, step.qcfg,
                             upto=3 if model == "lm" else 2)
    want, hw, dw, _ = _run(model, "aligned", steps, faults=faults,
                           ref_params=ref_params)
    assert deg == dw
    for a, b in zip(hw, hist):
        # the int8 params leg's float sums run over other tiles (each
        # bucket its own quantum): its E, a last-bit matter
        for k in a:
            if k in ("E_wire", "E_wire_params"):
                assert b[k] == pytest.approx(a[k], rel=1e-6), k
            else:
                assert b[k] == a[k], k
    for a, b in zip(tree_lib.leaves(want.params),
                    tree_lib.leaves(state.params)):
        assert torch.equal(a, b)
    for k in ("health", "trips", "skipped", "degraded", "cooldown",
              "overflow_ewma", "gnorm_ewma"):
        assert torch.equal(getattr(want.guard, k), getattr(state.guard, k))


def test_the_params_leg_trips_and_gathers_in_fp32(ref, monkeypatch):
    """``wire_params`` pinned to ⟨1, 7⟩ under weights above 1: its
    overflow rate crosses ``overflow_trip_hi`` on step 0, only the params
    leg degrades, step 1 gathers the parameters in fp32 (no int8
    all-gather), and every step equals the reference's."""
    gathers = []
    calls = {"n": 0}
    real = overlap_lib.zero_allgather_params

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(overlap_lib, "zero_allgather_params", counted)

    def on_step(i):
        gathers.append(calls["n"])
    state, hist, deg, step = _run("mlp", "aligned", NARROW_STEPS,
                               arrays=NARROW_ARRAYS, narrow=True,
                               on_step=on_step)
    gathers.append(calls["n"])
    int8_gathers = np.diff(gathers).tolist()
    assert deg[0] == [0, 1]                   # wire_grads, wire_params
    assert int8_gathers[0] == 1 and int8_gathers[1] == 0, int8_gathers
    assert int(hist[0]["health"]) & HEALTH_OVERFLOW_STORM
    assert not int(hist[0]["health"]) & HEALTH_SKIPPED
    _check_against_reference(ref, "narrow", "mlp", state, hist, deg,
                             step.qcfg)


# ---------------------------------------------------------------------------
# armed and idle: bit-transparent on every body
# ---------------------------------------------------------------------------

BODIES = {
    "zero_no_wire": dict(layout="aligned", wire=False),
    "zero_plain": dict(layout="plain"),
    "zero_aligned": dict(layout="aligned"),
    "zero_overlap": dict(layout="overlap"),
    "overlap": dict(layout="overlap", zero=False),
}


@pytest.mark.parametrize("model", ["mlp", "lm"])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_armed_idle_guards_change_nothing(one_thread, body, model):
    """Stochastic rounding, 3 steps: with the guards armed and no fault,
    every metric of the unguarded run and the whole state (parameters,
    optimizer state, DPS state) are bit-equal; the health word stays 0."""
    kw = dict(BODIES[body], rounding="stochastic")
    s0, h0, _, step0 = _run(model, steps=3, guards=False, **kw)
    sg, hg, _, step = _run(model, steps=3, **kw)
    assert step.guards_active and step.zero_opt_active == kw.get("zero", True)
    for a, b in zip(h0, hg):
        assert {k: b[k] for k in a} == a
        assert b["health"] == b["skipped"] == b["trips"] == b["degraded"] == 0
    f0, fg = flatten_tree(s0), flatten_tree(sg)
    for k, v in f0.items():
        np.testing.assert_array_equal(fg[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# faults in the hooks equal faults on the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults", [NAN, STORM], ids=["nan", "storm"])
@pytest.mark.parametrize("zero", [False, True])
def test_hooked_faults_equal_tree_faults(one_thread, zero, faults):
    """The smoke LM, nearest rounding, 4 steps with the guards and a fault
    at step 1: the overlapped step (the faults and the nonfinite signal
    taken leaf by leaf in its backward hooks, the degraded step's leaves
    summed by the fp32 sink's ``encode_leaf``) and the monolithic one (the
    tree-wise faults) give the same metrics and states, bit for bit."""
    kw = dict(faults=faults, zero=zero)
    want, hw, dw, _ = _run("lm", "aligned", 4, **kw)
    got, hg, dg, step = _run("lm", "overlap", 4, **kw)
    assert step.wire_overlap_active
    assert hw == hg and dw == dg
    assert hg[1]["skipped"] == 1 or faults is STORM
    assert hg[1]["degraded"] == 1
    for a, b in zip(tree_lib.leaves(want.params), tree_lib.leaves(got.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ZeRO-1 checkpoints under torchrun
# ---------------------------------------------------------------------------

def _cli(d, *extra):
    return ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu", "--steps",
            "4", "--batch", "4", "--seq", "8", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--zero-opt", "--log-every", "1",
            "--ckpt-dir", str(d), *extra]


def _launch(args, nproc=0):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    head = [sys.executable]
    if nproc:
        head += ["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(nproc)]
    out = subprocess.run([*head, "-m", "repro_torch.launch.train", *args],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _digests(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["digests"]


def _step_lines(text):
    return [l for l in text.splitlines() if l.startswith("step ")]


def test_zero_checkpoints_under_torchrun(tmp_path):
    """Two gloo processes with ``--zero-opt``: pre-empted at step 2 (a real
    SIGTERM), the checkpoint gathers both ranks' momenta rows to rank 0;
    ``--resume`` gives each process its own row back and runs steps 2-3
    as the straight run does; the step-4 checkpoints of the resumed, the
    straight and the stacked ``--data-ranks 2`` run hold equal arrays."""
    pre = _launch(_cli(tmp_path / "t", "--sigterm-at", "2"), nproc=2)
    assert "PREEMPTED: signal 15 (checkpointed at step 2)" in pre
    res = _launch(_cli(tmp_path / "t", "--resume"), nproc=2)
    assert "resumed from step 2 (data cursor 2)" in res
    straight = _launch(_cli(tmp_path / "s"), nproc=2)
    stacked = _launch(_cli(tmp_path / "k", "--data-ranks", "2"))
    assert _step_lines(pre) + _step_lines(res) == _step_lines(straight)
    assert _step_lines(straight) == _step_lines(stacked)
    want = _digests(tmp_path / "k", 4)
    assert _digests(tmp_path / "s", 4) == want
    assert _digests(tmp_path / "t", 4) == want
    with np.load(tmp_path / "t" / "step_00000002" / "arrays.npz") as z:
        assert z[".opt_state/mu"].shape[0] == 2       # both ranks' rows


# ---------------------------------------------------------------------------
# the ZeRO state converter
# ---------------------------------------------------------------------------

def _mlp_zero_state(steps):
    """The MLP's ZeRO-1 run (per-layer formats, no guards) after
    ``steps`` steps, and its step function and batch."""
    loss_fn, params, batch_at, opt = _model("mlp")
    qcfg = _qcfg(params, "aligned", guards=False)
    tr = StackedTransport(N)
    step = qtrain.make_train_step(loss_fn, opt, qcfg, transport=tr)
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, tr, qcfg), qcfg, 1)
    for i in range(steps):
        state, _ = step(state, batch_at(i))
    return state, step, batch_at(0), qcfg


def test_zero_opt_state_converts_both_ways():
    """Port rows -> the reference's flat vector -> port rows, and back: the
    same arrays (the two layouts pad with zeros in other places)."""
    state, _, _, qcfg = _mlp_zero_state(2)
    tr = StackedTransport(N)
    mu = state.opt_state["mu"]
    assert float(mu.abs().sum()) > 0
    flat = zero_opt_state_to_jax(state.opt_state, state.params, qcfg, N)
    back = zero_opt_state_from_jax(flat, state.params, qcfg, tr)
    assert torch.equal(back["mu"], mu)
    again = zero_opt_state_to_jax(back, state.params, qcfg, N)
    np.testing.assert_array_equal(again["mu"], flat["mu"])
    with pytest.raises(ValueError, match="layout holds"):
        zero_opt_state_to_jax({"mu": mu[:, :-1]}, state.params, qcfg, N)


def test_reference_restores_a_converted_zero_checkpoint(tmp_path):
    """The port's ZeRO state after 2 steps, its momenta converted to the
    reference's flat layout and saved in the checkpoint format: the
    reference restores it and its next step equals the port's."""
    state, step, batch, qcfg = _mlp_zero_state(2)
    flat = flatten_tree(state)
    conv = zero_opt_state_to_jax(state.opt_state, state.params, qcfg, N)
    flat[".opt_state/mu"] = conv["mu"]
    save_flat(str(tmp_path), 2, flat)
    out = run_reference([{"job": "zero_restore_step", "tag": "r", "kw": {
        "root": str(tmp_path), "at": 2, "n": N}}],
        {f"r/{k}": v for k, v in MLP_ARRAYS.items()}, host_devices=N)
    state, m = step(state, batch)
    for k in FORMATS:
        np.testing.assert_allclose(float(m[k]), out[f"r/next/{k}"],
                                   rtol=FORMAT_MEAN_RTOL, err_msg=k)
    np.testing.assert_allclose(float(m["loss"]), out["r/next/loss"],
                               rtol=MLP_LOSS_RTOL)
    final = {k: torch.from_numpy(out[f"r/final/{k}"]) for k in MLP_SHAPES}
    _check_params(state.params, final, float(m["fl_wire_params"]), 2,
                  MLP_PARAM_DIFF_FRACTION)
    mu = zero_opt_state_to_jax(state.opt_state, state.params, qcfg, N)["mu"]
    want = out["r/opt/mu"]
    assert float(np.linalg.norm(mu - want)
                 / np.linalg.norm(want)) <= MU_NORM_RTOL["mlp"]
