"""Data-parallel training over the int8 wire: the port's step against the
JAX package's, and its transports against each other.

* Step parity: the smoke llama3.2-3b, 3 SGD steps under nearest rounding,
  per-layer wire formats, 2 ranks — the port on ``StackedTransport(2)``, the
  reference under ``shard_map`` on 2 forced CPU devices — from the reference's
  own parameters (``convert``): ⟨IL, FL⟩ of all four domains identical step by
  step (the per-layer wire formats' mean, min and max), the loss to 1e-4
  relative (fp32 products summed in another order, as for the replicated
  step's parity test), E_wire, E_g and E_a, and the parameters after the
  last step.
* ``ProcessGroupTransport`` over gloo, two processes (``spawn``, a
  ``FileStore`` in the test's own directory, so parallel test workers share
  no port), against ``StackedTransport(2)``: two train steps under both
  rounding modes give bit-equal parameters and equal formats.
* With one rank the wire step is the replicated step, bit for bit.
* The training CLI with ``--grad-allreduce-bits 8 --data-ranks 2`` on the
  CPU.
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
from repro_torch.dist import ProcessGroupTransport, StackedTransport
from repro_torch.launch import train as train_cli
from repro_torch.models import registry, transformer
from repro_torch.models.common import init_params
from repro_torch.optim import SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

CFG = dataclasses.replace(smoke(get_config("llama3_2_3b")), remat="full")
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g", "il_wire_grads",
        "fl_wire_grads", "il_wire_grads_min", "il_wire_grads_max",
        "fl_wire_grads_min", "fl_wire_grads_max")
LOSS_RTOL = 1e-4
# E_wire is a mean relative error over every gradient element, and the two
# frameworks' gradients differ in the last bits of fp32 (products summed in
# another order), which moves a few elements across a rounding boundary of
# the wire grid; one element moved shifts E_wire by ~1e-5 of itself on this
# model (~1e5 gradient elements).  Measured: 1.8e-6 relative at worst over
# these 3 steps (the loss: 1.7e-7).
E_WIRE_RTOL = 1e-4
# E_g and E_a are mean relative errors too, over the raw gradients and the
# taps, where elements near zero weigh most.  Measured: 7.6e-3 (E_g) and
# 3.2e-3 (E_a) relative at worst over these 3 steps.
E_COMPUTE_RTOL = 2e-2
# The parameters after 3 steps: an element whose gradient crossed a rounding
# boundary of the wire or gradient grid in one framework and not in the
# other moves by a few steps of the weight grid.  Measured: 17 of 94,528
# elements differ, by at most 3 steps of 2^-FL_w; every other element is
# bit-equal.  A wrong mean (one rank's gradients twice, say) moves most.
PARAM_DIFF_FRACTION = 5e-4
PARAM_DIFF_STEPS = 4
WIRE_LM = dict(steps=3, seq=16, batch=2, n=2)


@pytest.fixture(scope="module")
def ref():
    return run_reference([{"job": "wire_lm_train", "tag": "wlm",
                           "kw": WIRE_LM}], host_devices=WIRE_LM["n"])


def _wire_qcfg(params, **kw):
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8, **kw)
    return qcfg.with_per_layer_wire(params)


def _run(step, state, steps, seq, batch, keys):
    data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=seq,
                                         global_batch=batch, seed=0))
    hist = {k: [] for k in keys}
    for i in range(steps):
        state, m = step(state, data.batch(i))
        for k in keys:
            hist[k].append(float(m[k]))
    return state, hist


def test_wire_steps_match_the_shard_map_reference(ref):
    """2 ranks, nearest rounding, per-layer wire formats, from the
    reference's parameters: every domain's formats step by step, the loss,
    E_wire, E_g and E_a, and the parameters the steps end with."""
    params = params_from_jax(unflatten(ref, "wlm/params/"), CFG, "cpu",
                             training=True)
    qcfg = _wire_qcfg(params, rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=StackedTransport(2))
    assert step.wire_sync_active
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    state, hist = _run(step, state, WIRE_LM["steps"], WIRE_LM["seq"],
                       WIRE_LM["batch"],
                       FMTS + ("loss", "E_wire", "R_wire", "E_g", "E_a"))
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k]),
                                      ref[f"wlm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref["wlm/hist/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist["E_wire"], ref["wlm/hist/E_wire"],
                               rtol=E_WIRE_RTOL)
    np.testing.assert_array_equal(hist["R_wire"], ref["wlm/hist/R_wire"])
    for k in ("E_g", "E_a"):
        np.testing.assert_allclose(hist[k], ref[f"wlm/hist/{k}"],
                                   rtol=E_COMPUTE_RTOL, err_msg=k)
    # the wire controller moved: the comparison is not of constants
    assert len(set(hist["il_wire_grads"])) > 1
    final = params_from_jax(unflatten(ref, "wlm/final/"), CFG, "cpu",
                            training=True)
    step_w = 2.0 ** -hist["fl_w"][-1]
    total = differ = 0
    for (path, got), (_, want) in zip(tree_lib.leaves_with_path(state.params),
                                      tree_lib.leaves_with_path(final)):
        gap = (got - want).abs()
        assert float(gap.max()) <= PARAM_DIFF_STEPS * step_w, path
        total, differ = total + got.numel(), differ + int((gap > 0).sum())
    assert differ <= PARAM_DIFF_FRACTION * total, (differ, total)


def _smoke_params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_params(transformer.model_defs(CFG, CFG.master_dtype()), "cpu",
                       gen)


def _train(transport, rounding, steps=2, batch=4):
    """``steps`` wire steps of the smoke LM on ``transport``; returns the
    parameters and the formats of every step."""
    params = _smoke_params()
    qcfg = _wire_qcfg(params, rounding=rounding)
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=transport)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 3)
    state, hist = _run(step, state, steps, 8, batch, FMTS + ("loss",))
    return ({k: v.clone() for k, v in
             tree_lib.leaves_with_path(state.params)}, hist)


def _gloo_rank(rank, world, store_path, out_path):
    """One process of the gloo run: join the group through the file store,
    train under both rounding modes, save what came out."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {mode: _train(ProcessGroupTransport(), mode)
               for mode in ("nearest", "stochastic")}
        # the mean is the same on every rank: a second check of the wire
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_process_group_transport_over_gloo_equals_the_stacked_one(tmp_path):
    world = 2
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
    for mode in ("nearest", "stochastic"):
        want_params, want_hist = _train(StackedTransport(world), mode)
        for got_params, got_hist in (run[mode] for run in runs):
            assert got_params.keys() == want_params.keys()
            for k, v in want_params.items():
                assert torch.equal(got_params[k], v), (mode, k)
            for k in FMTS:
                assert got_hist[k] == want_hist[k], (mode, k)
            assert got_hist["loss"] == want_hist["loss"], mode


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_one_rank_wire_step_is_the_replicated_step(one_thread, rounding):
    """With one rank there is nothing to all-reduce: the step with the wire
    switched on equals the one without, parameters and formats bit for bit."""
    runs = []
    for wire in (False, True):
        params = _smoke_params()
        qcfg = (_wire_qcfg(params, rounding=rounding) if wire
                else qtrain.QuantConfig(rounding=rounding))
        opt = make_optimizer(SGDConfig())
        step = qtrain.make_train_step(
            registry(CFG.family).loss_fn(CFG), opt, qcfg,
            transport=StackedTransport(1) if wire else None)
        assert not step.wire_sync_active
        state = qtrain.TrainState.create(params, opt.init(params), qcfg, 3)
        keys = ("loss",) + FMTS[:6]
        state, hist = _run(step, state, 3, 8, 2, keys)
        runs.append((tree_lib.leaves(state.params), hist))
    (p0, h0), (p1, h1) = runs
    assert h0 == h1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_wire_step_checks_its_batch_and_widths():
    params = _smoke_params()
    opt = make_optimizer(SGDConfig())
    loss = registry(CFG.family).loss_fn(CFG)
    with pytest.raises(ValueError, match="2..8"):
        qtrain.make_train_step(loss, opt, qtrain.QuantConfig(
            grad_allreduce_bits=9), transport=StackedTransport(2))
    qcfg = _wire_qcfg(params)
    step = qtrain.make_train_step(loss, opt, qcfg,
                                  transport=StackedTransport(3))
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 3)
    with pytest.raises(ValueError, match="does not split"):
        step(state, TokenStream(TokenStreamConfig(
            vocab=CFG.vocab, seq_len=8, global_batch=4)).batch(0))
    # per-layer formats need one group per gradient leaf
    bad = dataclasses.replace(qcfg, wire_grads_groups=3)
    step = qtrain.make_train_step(loss, opt, bad, transport=StackedTransport(2))
    state = qtrain.TrainState.create(params, opt.init(params), bad, 3)
    with pytest.raises(ValueError, match="one group per leaf"):
        step(state, TokenStream(TokenStreamConfig(
            vocab=CFG.vocab, seq_len=8, global_batch=2)).batch(0))


@pytest.mark.parametrize("groups", ["per-layer", "global"])
def test_train_cli_wire_smoke_on_the_cpu(capsys, groups):
    out = train_cli.main(["--arch", "llama3_2_3b", "--smoke", "--device",
                          "cpu", "--steps", "6", "--batch", "4", "--seq", "8",
                          "--log-every", "1", "--optimizer", "sgd",
                          "--grad-allreduce-bits", "8", "--data-ranks", "2",
                          "--wire-groups", groups])
    text = capsys.readouterr().out
    assert text.count("E_wire") >= 6 and "wg<" in text
    assert out["wire_sync"] and out["data_ranks"] == 2
    hist = out["history"]
    assert len(hist) == 6 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(np.isfinite(h["E_wire"]) and 0 <= h["R_wire"] <= 1
               for h in hist)
    assert np.isfinite(out["E_wire"]) and out["R_wire"] is not None
    # the wire controller moved the formats
    assert len({h["il_wire_grads"] for h in hist}) > 1
    # on the CPU the plain versions run: no kernel launch is counted
    assert all(set(w.values()) == {0} for w in out["wire_launches_per_step"])


def test_train_cli_rejects_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        train_cli.main(["--arch", "llama3_2_3b", "--smoke", "--device", "cpu",
                        "--steps", "1", "--batch", "3", "--seq", "8",
                        "--grad-allreduce-bits", "8", "--data-ranks", "2"])


def test_wire_config_adds_its_domain_and_per_layer_groups():
    params = _smoke_params()
    plain = qtrain.QuantConfig()
    assert "wire_grads" not in plain.plan()
    assert plain.with_per_layer_wire(params) is plain
    qcfg = _wire_qcfg(params)
    spec = qcfg.plan().spec("wire_grads")
    assert spec.groups == len(tree_lib.leaves(params)) and spec.wire


def _count_wire_step(monkeypatch, n, onchip_prng):
    """One wire step of the smoke LM on ``StackedTransport(n)`` under
    stochastic rounding, every kernel call counted where its plain version
    runs; returns the counts and (G, Q, L)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import dps_quant as dq
    counts = dict.fromkeys(("K1", "K1b", "K2", "K2b", "K3", "K3b", "K4"), 0)
    quant_call = dq._quant_call

    def counted_quant_call(x, il, fl, bits, compute_stats, out, backend, wire):
        prng = isinstance(bits, dq.Philox)
        counts[("K2" if wire else "K1") + ("b" if prng else "")] += 1
        return quant_call(x, il, fl, bits, compute_stats, out, backend, wire)

    group_plain, reduce_plain = (dq.dps_quant_group_wire_plain,
                                 dq.dps_wire_reduce_plain)

    def counted_group(x, tab, tg, bits=None, *a, **k):
        counts["K3b" if isinstance(bits, dq.GroupPhilox) else "K3"] += 1
        return group_plain(x, tab, tg, bits, *a, **k)

    def counted_reduce(*a, **k):
        counts["K4"] += 1
        return reduce_plain(*a, **k)

    monkeypatch.setattr(dq, "_quant_call", counted_quant_call)
    monkeypatch.setattr(dq, "dps_quant_group_wire_plain", counted_group)
    monkeypatch.setattr(dq, "dps_wire_reduce_plain", counted_reduce)
    params = _smoke_params()
    qcfg = _wire_qcfg(params, onchip_prng=onchip_prng)
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt,
                                  qcfg, transport=StackedTransport(n))
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 3)
    _run(step, state, 1, 8, n, ("loss",))
    pred = QuantPolicy().param_predicate()
    paths = tree_lib.leaves_with_path(transformer.model_defs(CFG))
    return counts, (len(paths), sum(pred(p, d) for p, d in paths),
                    CFG.n_layers)


def test_wire_step_launch_counts_rehearse_the_card(monkeypatch):
    """One wire step on the CPU with every kernel call counted where its
    plain version runs: the counts ``chip_smoke.py`` holds the card's
    launches to.  Per step, with Q quantized leaves of G, L layers and n
    ranks: K1b 3Q + n(2L + Q) (weights, the optimizer-input snap and the
    re-snap once; each rank's taps forward and backward and its raw-gradient
    statistics), K2b n·G (leg 1, leaf by leaf), K4 n and K3b n (one owner
    chunk each)."""
    n = 4
    counts, (G, Q, L) = _count_wire_step(monkeypatch, n, onchip_prng=True)
    assert counts == {"K1": 0, "K1b": 3 * Q + n * (2 * L + Q), "K2": 0,
                      "K2b": n * G, "K3": 0, "K3b": n, "K4": n}


def test_wire_step_with_a_bits_operand_runs_k2_and_k3(monkeypatch):
    """``onchip_prng=False`` (``--rounding-bits operand``) takes the wire's
    bits from an operand too: K2 on leg 1, K3 on leg 2, and K1 on every
    compute event (at this size no leaf is split by layer)."""
    n = 3
    counts, (G, Q, L) = _count_wire_step(monkeypatch, n, onchip_prng=False)
    assert counts == {"K1": 3 * Q + n * (2 * L + Q), "K1b": 0, "K2": n * G,
                      "K2b": 0, "K3": n, "K3b": 0, "K4": n}
