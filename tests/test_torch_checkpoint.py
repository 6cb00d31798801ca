"""Checkpoints of the port against the reference's, and resume.

* The port's flattened ``TrainState`` has the reference's keys, shapes and
  dtypes (SGD, AdamW, the replicated and the per-layer wire plan, guards
  armed) — the reference's ``flatten_tree`` of its own smoke state in a
  child process.
* A checkpoint the reference writes (in the child) restores into the port
  bit for bit — replicated, wire, guarded, AdamW, and ZeRO-1 through
  ``convert.zero_ckpt_adapter`` — and the port's next step under nearest
  rounding matches the reference's next step: the loss to ``LOSS_RTOL``,
  every DPS state exactly, the parameters as the wire parity test allows.
* The reverse: a checkpoint the port writes restores through the reference's
  ``restore`` into its ``abstract_train_state``, bit for bit; a port ZeRO-1
  checkpoint (the port's flat layout) is refused by shape.
* A resumed port run equals the uninterrupted one bit for bit, every metric
  and the whole final state, under nearest and stochastic rounding, for the
  replicated step, the wire step at 2 ranks and ZeRO-1; and through the CLI
  (the crash path's checkpoint, then ``--resume``), manifest digests and
  all.
* ``verify_step``, ``latest_step``'s walk-back, ``restore`` refusing a
  corrupt array, ``prune``, ``AsyncCheckpointer`` surfacing a background
  error, and ``.rng`` <-> seed.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import _reference_partitioner, zero_ckpt_adapter
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.dist import StackedTransport
from repro_torch.launch import train as train_cli
from repro_torch.models import registry, transformer
from repro_torch.models.common import init_params
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer
from repro_torch.resilience import GuardConfig, corrupt_checkpoint
from test_torch_jaxref import one_thread, run_reference  # noqa: F401

CFG = dataclasses.replace(smoke(get_config("llama3_2_3b")), remat="full")
# the loss of one step from the same state: fp32 products summed in another
# order (as tests/test_torch_train.py and test_torch_wire_train.py allow)
LOSS_RTOL = 1e-4
# the parameters after one step from the same state: an element whose
# gradient crossed a rounding boundary of the wire or gradient grid in one
# framework and not the other moves by a few weight-grid steps (the wire
# parity test's bounds, there over 3 steps)
PARAM_DIFF_FRACTION = 5e-4
PARAM_DIFF_STEPS = 4
# the guard's float EWMAs: one step's gradient norm, summed in another order
GUARD_RTOL = 1e-4

KEY_CASES = {
    "sgd": dict(opt="sgd"),
    "adamw": dict(opt="adamw"),
    "wire": dict(n=2),
    "guards": dict(guards=True),
    "wire_guards": dict(n=2, guards=True),
}
# checkpoints at step 2 of each case, written by one package and read by
# the other
SAVE_CASES = {
    "rep": dict(steps=2),
    "adamw": dict(opt="adamw", steps=2),
    "wire": dict(n=2, steps=2),
    "wire_guards": dict(n=2, guards=True, steps=2),
    "zero": dict(n=2, zero=True, steps=2),
}


def _setup(case, init_seed=0):
    """The port's side of a case (see ``test_torch_jaxref._ckpt_setup``):
    ``(step, state, data)``, parameters drawn from ``init_seed``."""
    n, zero = case.get("n", 0), case.get("zero", False)
    params = init_params(transformer.model_defs(CFG, CFG.master_dtype()),
                         "cpu", torch.Generator().manual_seed(init_seed))
    kw = dict(rounding=case.get("rounding", "nearest"))
    if n:
        kw["grad_allreduce_bits"] = 8
    if zero:
        kw["zero_opt_shards"] = n
    if case.get("guards"):
        kw["guards"] = GuardConfig()
    qcfg = qtrain.QuantConfig(**kw).with_per_layer_wire(params)
    opt = make_optimizer(AdamWConfig() if case.get("opt") == "adamw"
                         else SGDConfig())
    transport = StackedTransport(n) if n else None
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=transport)
    if zero:
        _, params = qtrain.zero_partitioner(qcfg, params, n).flat_view(params)
        opt_state = qtrain.zero_opt_state(opt, params, transport, qcfg)
    else:
        opt_state = opt.init(params)
    state = qtrain.TrainState.create(params, opt_state, qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=8,
                                         global_batch=max(2, 2 * n), seed=0))
    return step, state, data


def _defaults(step):
    d = qtrain.dps_restore_defaults(step.qcfg)
    d.update(qtrain.guard_restore_defaults(step.qcfg))
    return d


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's keys, its checkpoints (and the steps after them) and
    its restores of the port's checkpoints, in one child."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    port_flat = {}
    for name, case in SAVE_CASES.items():
        step, state, data = _setup(case)
        for i in range(case["steps"]):
            state, _ = step(state, data.batch(i))
        ckpt.save(os.path.join(root, "port", name), case["steps"], state,
                  meta=data.state(case["steps"]))
        port_flat[name] = ckpt.flatten_tree(state)
    out = run_reference([
        {"job": "ckpt_keys", "tag": "keys", "kw": {"cases": KEY_CASES}},
        {"job": "ckpt_save", "tag": "save",
         "kw": {"root": os.path.join(root, "ref"), "cases": SAVE_CASES}},
        {"job": "ckpt_restore", "tag": "restore",
         "kw": {"root": os.path.join(root, "port"), "cases": SAVE_CASES}},
    ], host_devices=2)
    return root, out, port_flat


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", sorted(KEY_CASES))
def test_flattened_state_has_the_reference_keys(ref, name):
    _, out, _ = ref
    want = json.loads(str(out[f"keys/{name}/keys"]))
    got = {k: [list(v.shape), str(v.dtype)] for k, v in
           ckpt.flatten_tree(_setup(KEY_CASES[name])[1]).items()}
    assert got == want


def _restore_ref(root, name):
    case = SAVE_CASES[name]
    step, state, data = _setup(case, init_seed=7)
    adapt = (zero_ckpt_adapter(state.params, step.qcfg, step.transport)
             if case.get("zero") else None)
    _, meta = ckpt.restore(os.path.join(root, "ref", name), case["steps"],
                           state, defaults=_defaults(step), adapt=adapt)
    return step, state, data, meta


@pytest.mark.parametrize("name", sorted(SAVE_CASES))
def test_reference_checkpoint_restores_into_the_port_bit_for_bit(ref, name):
    root, _, _ = ref
    case = SAVE_CASES[name]
    step, state, _, meta = _restore_ref(root, name)
    assert meta == {"cursor": case["steps"], "seed": 0}
    assert state.step == case["steps"] and state.seed == 1
    path = os.path.join(root, "ref", name, f"step_{case['steps']:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    got = ckpt.flatten_tree(state)
    if case.get("zero"):
        # the port keeps its own flat layout: unflattened, the optimizer
        # state is the reference's leaf for leaf
        n = case["n"]
        part = qtrain.zero_partitioner(step.qcfg, state.params, n)
        refp = _reference_partitioner(step.qcfg, state.params, n, "jnp")
        mu = torch.as_tensor(saved.pop(".opt_state/mu"))
        want = refp.unflatten(refp.assemble(mu.view(n, refp.shard_size)))
        have = part.unflatten(part.assemble(state.opt_state["mu"]))
        for (p, a), (_, b) in zip(tree_lib.leaves_with_path(have),
                                  tree_lib.leaves_with_path(want)):
            assert torch.equal(a, b), p
        del got[".opt_state/mu"]
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["rep", "wire", "wire_guards", "zero"])
def test_port_step_after_a_reference_checkpoint_matches_the_reference(
        ref, name):
    root, out, _ = ref
    case = SAVE_CASES[name]
    step, state, data, _ = _restore_ref(root, name)
    state, m = step(state, data.batch(case["steps"]))
    np.testing.assert_allclose(float(m["loss"]),
                               out[f"save/{name}/next/loss"], rtol=LOSS_RTOL)
    after = _sub(out, f"save/{name}/after/")
    got = ckpt.flatten_tree(state)
    for k, v in after.items():
        if k.startswith((".dps/", ".step", ".rng")):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        elif k.startswith(".guard/"):
            np.testing.assert_allclose(got[k], v, rtol=GUARD_RTOL,
                                       err_msg=k)
    if case.get("guards"):
        assert int(m["health"]) == 0 and int(m["skipped"]) == 0
    grid = 2.0 ** -float(m["fl_w"])
    total = differ = 0
    for k, v in after.items():
        if k.startswith(".params/"):
            gap = np.abs(got[k] - v)
            assert gap.max() <= PARAM_DIFF_STEPS * grid, k
            total, differ = total + v.size, differ + int((gap > 0).sum())
    assert differ <= PARAM_DIFF_FRACTION * total, (differ, total)


@pytest.mark.parametrize("name", ["rep", "adamw", "wire", "wire_guards"])
def test_port_checkpoint_restores_in_the_reference_bit_for_bit(ref, name):
    _, out, port_flat = ref
    got = _sub(out, f"restore/{name}/")
    assert int(got.pop("cursor")) == SAVE_CASES[name]["steps"]
    want = port_flat[name]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_zero_checkpoint_is_refused_by_the_reference_by_shape(ref):
    """The port writes its own ZeRO-1 flat layout ([ranks, shard]); the
    reference's restore refuses it by shape instead of misreading it."""
    _, out, _ = ref
    assert "shape mismatch for .opt_state/mu" in str(out["restore/zero/error"])


def test_guard_free_checkpoint_resumes_a_guarded_run(ref):
    """The schema-upgrade defaults: the guard subtree a checkpoint lacks
    starts fresh."""
    root, _, _ = ref
    step, state, _ = _setup(dict(n=2, guards=True))
    ckpt.restore(os.path.join(root, "ref", "wire"), 2, state,
                 defaults=_defaults(step))
    assert state.step == 2 and int(state.guard.health) == 0
    assert int(state.guard.prev_il[0]) == 6
    with pytest.raises(KeyError, match=".guard/.health"):
        ckpt.restore(os.path.join(root, "ref", "wire"), 2, state)


# ---------------------------------------------------------------------------
# resume == uninterrupted, bit for bit
# ---------------------------------------------------------------------------

RESUME_PATHS = {"replicated": dict(), "wire": dict(n=2),
                "zero": dict(n=2, zero=True)}


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("path", sorted(RESUME_PATHS))
def test_resumed_run_equals_the_uninterrupted_one(one_thread, tmp_path, path,
                                                  rounding):
    case = dict(RESUME_PATHS[path], rounding=rounding)
    step, state, data = _setup(case)
    straight = []
    for i in range(4):
        state, m = step(state, data.batch(i))
        straight.append({k: float(v) for k, v in m.items()})
    want = ckpt.flatten_tree(state)

    step, state, data = _setup(case)
    for i in range(2):
        state, _ = step(state, data.batch(i))
    ckpt.save(str(tmp_path), 2, state)
    # a fresh template from other parameters: the restore must overwrite
    # every leaf, in place (ZeRO's parameters stay views of its buffer)
    step, state, data = _setup(case, init_seed=5)
    views = [l.data_ptr() for l in tree_lib.leaves(state.params)]
    ckpt.restore(str(tmp_path), 2, state)
    assert [l.data_ptr() for l in tree_lib.leaves(state.params)] == views
    resumed = []
    for i in range(2, 4):
        state, m = step(state, data.batch(i))
        resumed.append({k: float(v) for k, v in m.items()})
    assert resumed == straight[2:]
    got = ckpt.flatten_tree(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert ckpt_mod._digest(got[k]) == ckpt_mod._digest(want[k]), k


def _cli(d, *extra):
    return ["--arch", "llama3_2_3b", "--smoke", "--device", "cpu", "--steps",
            "4", "--batch", "4", "--seq", "8", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", "2",
            "--log-every", "1", "--ckpt-dir", str(d), *extra]


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_cli_crash_checkpoint_and_resume_equal_the_uninterrupted_run(
        one_thread, tmp_path, capsys):
    """``--fail-at 2`` checkpoints step 2 and exits 17; ``--resume`` runs
    steps 2-3 with every metric bit-equal to the uninterrupted run's and
    ends on a step-4 checkpoint whose digests equal its."""
    a = train_cli.main(_cli(tmp_path / "a"))
    with pytest.raises(SystemExit) as e:
        train_cli.main(_cli(tmp_path / "b", "--fail-at", "2"))
    assert e.value.code == 17
    assert "ABORT: injected failure at step 2 (checkpointed at step 2)" \
        in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    b = train_cli.main(_cli(tmp_path / "b", "--resume"))
    assert "resumed from step 2 (data cursor 2)" in capsys.readouterr().out
    assert b["resumed"]["step"] == 2
    assert [h["step"] for h in b["history"]] == [2, 3]
    assert b["history"] == a["history"][2:]
    ma, mb = _manifest(tmp_path / "a", 4), _manifest(tmp_path / "b", 4)
    assert ma["digests"] == mb["digests"] and ma["meta"] == mb["meta"]
    assert [r["step"] for r in b["ckpt_saves"]] == [4]


# ---------------------------------------------------------------------------
# integrity, pruning, the async saver, the RNG key
# ---------------------------------------------------------------------------

def _small_tree(v=0.0):
    return {"w": torch.full((64, 16), v), "b": torch.arange(16.0),
            "h": torch.ones(8, dtype=torch.bfloat16)}


def test_save_is_atomic_and_verified(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, _small_tree(1.0), meta={"cursor": 3})
    assert ckpt.verify_step(d, 3)
    assert sorted(os.listdir(d)) == ["step_00000003"]
    m = _manifest(d, 3)
    assert m["version"] == 2 and m["keys"] == ["b", "h", "w"]
    with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as z:
        assert z["h"].dtype == np.float32          # bf16 widened
    back = _small_tree()
    _, meta = ckpt.restore(d, 3, back)
    assert meta == {"cursor": 3}
    assert torch.equal(back["w"], torch.full((64, 16), 1.0))
    assert back["h"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_latest_step_walks_back_past_corruption_and_restore_refuses(
        tmp_path, mode):
    d = str(tmp_path)
    for s in (2, 4):
        ckpt.save(d, s, _small_tree(float(s)))
    corrupt_checkpoint(d, 4, mode)
    assert not ckpt.verify_step(d, 4) and ckpt.verify_step(d, 2)
    assert ckpt.latest_step(d) == 2
    assert ckpt.latest_step(d, verify=False) == 4
    with pytest.raises(Exception) as e:
        ckpt.restore(d, 4, _small_tree())
    if mode == "bitflip":
        # a valid zip: only the digest catches it
        assert e.type is ValueError and "SHA-256" in str(e.value)
    # a torn write left behind by a crash is never a candidate
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 2


def test_latest_step_of_an_empty_or_missing_dir(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.latest_step(str(tmp_path)) is None


def test_prune_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, _small_tree())
    ckpt.prune(d, 2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_restore_refuses_a_shape_drift(tmp_path):
    ckpt.save(str(tmp_path), 1, _small_tree())
    tree = _small_tree()
    tree["w"] = torch.zeros(32, 16)
    with pytest.raises(ValueError, match="shape mismatch for w"):
        ckpt.restore(str(tmp_path), 1, tree)


def test_async_checkpointer_copies_before_returning_and_surfaces_errors(
        tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path / "c"), keep=2)
    tree = _small_tree(1.0)
    saver.save(1, tree)
    tree["w"].fill_(5.0)            # the next step overwrites in place
    saver.wait()
    back = _small_tree()
    ckpt.restore(str(tmp_path / "c"), 1, back)
    assert torch.equal(back["w"], torch.full((64, 16), 1.0))
    rec = saver.records[0]
    assert rec["step"] == 1 and rec["bytes"] == 64 * 16 * 4 + 16 * 4 + 8 * 4
    assert rec["stall_s"] >= 0 and rec["write_s"] >= 0
    # a save that fails in the background raises on wait(), once
    (tmp_path / "f").write_text("a file where the directory should be")
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "f"))
    bad.save(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()


def test_rng_key_data_round_trips_the_seed_and_refuses_other_keys():
    np.testing.assert_array_equal(ckpt.rng_of_seed(5),
                                  np.array([0, 5], np.uint32))
    assert ckpt.seed_of_rng(ckpt.rng_of_seed(123456)) == 123456
    for bad in (np.array([1, 5], np.uint32), np.array([0, 5], np.int32),
                np.array([0, 5, 0], np.uint32)):
        with pytest.raises(ValueError, match="no counterpart"):
            ckpt.seed_of_rng(bad)
    with pytest.raises(ValueError, match="uint32"):
        ckpt.rng_of_seed(1 << 32)
