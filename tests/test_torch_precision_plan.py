"""The port's custom precision plans, the optimizers' ``grad_domain`` and
``master_weights`` against the JAX package's.

The reference's own test of these (``tests/test_precision_plan.py``)
cannot run under the installed JAX; its cases run here through the
reference's trainer in a child (one child, ``run_reference``), under
nearest rounding:

* ``QuantConfig.precision_plan``: LeNet under the standard plan with two
  wire domains and a static ``kv_cache`` domain added takes the standard
  plan's trajectory bit for bit (domains nobody feeds or reads cannot
  perturb training: the counterpart of the reference's
  ``test_bits_none_step_bitexact_under_extra_domains``), and the
  reference's: every domain's formats equal, the loss within
  ``LOSS_RTOL``.  ``plan()`` returns the plan whole, and
  ``with_per_layer_wire`` leaves such a config as it is.
* ``grad_domain``: an optimizer whose input gradients snap to a domain of
  their own (``opt_in``, a paper controller from ⟨6, 10⟩ fed the grads
  stream) gives the reference's losses and formats, ``opt_in``'s too; a
  domain the plan lacks raises the reference's ``ValueError`` on every
  step body.
* ``master_weights``: no re-snap after the update — LeNet on the
  replicated step and the smoke LM on the placed step at (2, 4) give the
  reference's losses and parameters, and the parameters sit off the
  weight grid; on ZeRO-1 with the int8 wire the params leg warns with the
  reference's words and gathers in fp32 (stacked ranks), the reference's
  losses and formats.
* A checkpoint written under the standard plan restores into an extended
  plan with ``dps_restore_defaults``: the compute domains keep their
  trajectories, the new domains start fresh; without the defaults it
  raises.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.apps import mnist as app
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import lenet_params_from_jax, params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DomainSpec, DPSHyper, PrecisionPlan, wire_hyper
from repro_torch.data import MNISTLike, TokenStream, TokenStreamConfig
from repro_torch.dist.sharding import gather_placed
from repro_torch.dist.transport import StackedTransport
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import lenet
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

LENET = dict(steps=3, n_train=256, fl_init=6)
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
LOSS_RTOL = 1e-4                # tests/test_torch_train.py's LeNet bound
PLACED = dict(steps=3, seq=16, batch=8, mesh=[2, 4])
PLACED_LOSS_RTOL = 2e-4         # the reference's own sharded-step bound
PARAM_DIFF_STEPS = 4            # tests/test_torch_tp.py's
N = 4                           # ZeRO ranks
MLP_SHAPES = {"w1": (16, 24), "b1": (24,), "w2": (24, 8)}
MLP_STEPS = 3
MLP_LOSS_RTOL = 1e-5            # tests/test_torch_zero.py's


def _mlp_arrays():
    rng = np.random.default_rng(5)
    out = {f"params/{k}": (rng.standard_normal(s) * 0.3).astype(np.float32)
           for k, s in MLP_SHAPES.items()}
    out["x"] = rng.standard_normal((32, 16)).astype(np.float32)
    out["y"] = rng.standard_normal((32, 8)).astype(np.float32)
    return out


MLP_ARRAYS = _mlp_arrays()


@pytest.fixture(scope="module")
def ref():
    return run_reference(
        [{"job": "precision_plan", "tag": "ln", "kw": LENET},
         {"job": "zero_mlp_train", "tag": "zm",
          "kw": {"steps": MLP_STEPS, "n": N, "master_weights": True}},
         {"job": "sharded_step", "tag": "pl",
          "kw": {**PLACED, "whole": False, "master_weights": True}}],
        {f"zm/{k}": v for k, v in MLP_ARRAYS.items()}, host_devices=8)


def _base():
    return app.paper_quant_config(rounding="nearest",
                                  fl_init=LENET["fl_init"])


def _plans():
    domains = _base().plan().domains
    return {
        "std": None,
        "ext": PrecisionPlan(domains + (
            ("wire_grads", DomainSpec("flexpoint", wire_hyper(8, 6, -2.0))),
            ("wire_params", DomainSpec("flexpoint", wire_hyper(8, 2, 1.0))),
            ("kv_cache", DomainSpec("static", DPSHyper(il_init=8,
                                                       fl_init=8))))),
        "gd": PrecisionPlan(domains + (("opt_in", DomainSpec(
            "paper", DPSHyper(il_init=6, fl_init=10), stats="grads")),)),
    }


def _sgd(grad_domain="grads"):
    opt = make_optimizer(SGDConfig())
    opt.grad_domain = grad_domain
    return opt


def _lenet(ref, plan=None, grad_domain="grads", master=False):
    """LeNet from the reference's initial parameters, ``LENET["steps"]``
    SGD steps: (history, state)."""
    params = lenet_params_from_jax(unflatten(ref, "ln/params/"), "cpu")
    qcfg = dataclasses.replace(_base(), precision_plan=plan,
                               master_weights=master)
    opt = _sgd(grad_domain)
    step = qtrain.make_train_step(lenet.loss_fn, opt, qcfg)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1, "cpu")
    data = MNISTLike(batch=64, seed=0, n_train=LENET["n_train"], n_test=64)
    names = ("loss",) + FMTS + (("il_opt_in", "fl_opt_in")
                                if plan is not None and "opt_in" in plan
                                else ())
    hist = {k: [] for k in names}
    for i in range(LENET["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in data.train_batch(i).items()}
        state, m = step(state, batch)
        for k in names:
            hist[k].append(float(m[k]))
    return hist, state


@pytest.fixture(scope="module")
def std(ref):
    """The standard plan's LeNet run, on one CPU thread (a bit-for-bit
    comparison holds another run to it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _lenet(ref)
    finally:
        torch.set_num_threads(saved)


def _hold(hist, ref, key, rtol=LOSS_RTOL):
    for k in hist:
        if k == "loss":
            np.testing.assert_allclose(hist[k], ref[f"{key}/{k}"], rtol=rtol)
        else:
            np.testing.assert_array_equal(hist[k], ref[f"{key}/{k}"],
                                          err_msg=k)


def _off_grid(tree, fl: float) -> int:
    """Elements of a tree of tensors that are not multiples of 2^-fl."""
    scale = 2.0 ** fl
    return sum(int(((x * scale) != torch.round(x * scale)).sum())
               for x in tree_lib.leaves(tree))


def test_plan_returns_the_custom_plan_whole():
    plan = _plans()["ext"]
    q = dataclasses.replace(qtrain.QuantConfig(grad_allreduce_bits=8),
                            precision_plan=plan)
    assert q.plan() is plan
    assert q.with_per_layer_wire({"a": torch.zeros(2), "b": torch.zeros(3)}) \
        is q
    assert qtrain.init_dps_bundle(q).names() == plan.names


def test_extra_domains_take_the_standard_trajectory_bit_for_bit(ref, std,
                                                                one_thread):
    h_std, s_std = std
    h_ext, s_ext = _lenet(ref, _plans()["ext"])
    assert h_std == h_ext
    for k in s_std.params:
        assert torch.equal(s_std.params[k], s_ext.params[k]), k
    flat_std, flat_ext = ckpt.flatten_tree(s_std), ckpt.flatten_tree(s_ext)
    for k, v in flat_std.items():
        if k.startswith(".dps/"):
            np.testing.assert_array_equal(v, flat_ext[k], err_msg=k)
    assert {k for k in flat_ext if k.startswith(".dps/kv_cache/")}
    # ... and the reference's trajectory under the same plan
    _hold(h_ext, ref, "ln/ext/hist")
    assert len(set(h_ext["fl_w"])) > 1       # the controllers moved


def test_custom_grad_domain_gives_the_reference_losses_and_formats(ref, std):
    hist, state = _lenet(ref, _plans()["gd"], grad_domain="opt_in")
    _hold(hist, ref, "ln/gd/hist")
    assert len(set(hist["fl_opt_in"])) > 1
    # the domain reaches the update: the parameters leave the standard run's
    assert any(not torch.equal(state.params[k], std[1].params[k])
               for k in state.params)


@pytest.mark.parametrize("body", ["replicated", "wire", "zero", "placed"])
def test_a_grad_domain_the_plan_lacks_raises_the_references_error(ref, body):
    want = str(ref["ln/missing/error"])
    qcfg = _base()
    with pytest.raises(ValueError) as e:
        if body == "placed":
            cfg = smoke(get_config("llama3_2_3b"))
            specs.build_train_step(
                cfg, qtrain.QuantConfig(rounding="nearest"), _sgd("nope"),
                mesh=mesh_lib.make_mesh((2, 4), ("data", "model")))
        else:
            kw = {"wire": dict(grad_allreduce_bits=8),
                  "zero": dict(grad_allreduce_bits=8, zero_opt_shards=2),
                  "replicated": {}}[body]
            qtrain.make_train_step(lenet.loss_fn, _sgd("nope"),
                                   dataclasses.replace(qcfg, **kw),
                                   transport=StackedTransport(2))
    msg = str(e.value)
    if body in ("wire", "zero"):
        # the plan names its wire domains too
        want = want.replace("'grads')", "'grads', 'wire_grads'"
                            + (", 'wire_params')" if body == "zero" else ")"))
    assert msg == want


@pytest.mark.parametrize("opt_cfg", [SGDConfig(), AdamWConfig()],
                         ids=["sgd", "adamw"])
def test_optimizers_name_the_grads_domain(opt_cfg):
    assert make_optimizer(opt_cfg).grad_domain == "grads"


def test_master_weights_replicated_step_matches_the_reference(ref, std):
    hist, state = _lenet(ref, master=True)
    _hold(hist, ref, "ln/master/hist")
    fl_w = hist["fl_w"][-1]
    assert _off_grid(state.params, fl_w) > 0
    assert _off_grid(std[1].params, std[0]["fl_w"][-1]) == 0   # re-snapped
    for k, x in state.params.items():
        want = lenet_params_from_jax(unflatten(ref, "ln/master/final/"),
                                     "cpu")[k]
        assert float((x - want).abs().max()) <= PARAM_DIFF_STEPS * 2.0 ** -fl_w


def test_master_weights_placed_step_matches_the_reference(ref):
    cfg = dataclasses.replace(smoke(get_config("llama3_2_3b")), remat="full")
    params = params_from_jax(unflatten(ref, "pl/params/"), cfg, "cpu",
                             training=True)
    qcfg = qtrain.QuantConfig(rounding="nearest", master_weights=True)
    opt = make_optimizer(SGDConfig())
    mesh = mesh_lib.make_mesh(tuple(PLACED["mesh"]), ("data", "model"))
    step = specs.build_train_step(cfg, qcfg, opt, accum_steps=1, mesh=mesh)
    assert step.placed
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    specs.place_train_state(cfg, state, mesh)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=PLACED["seq"],
                                         global_batch=PLACED["batch"], seed=0))
    hist = {k: [] for k in ("loss",) + FMTS}
    for i in range(PLACED["steps"]):
        state, m = step(state, data.batch(i))
        for k in hist:
            hist[k].append(float(m[k]))
    np.testing.assert_allclose(hist["loss"], ref["pl/sharded/hist/loss"],
                               rtol=PLACED_LOSS_RTOL)
    final = gather_placed(state.params)
    fl_w = hist["fl_w"][-1]
    assert _off_grid(final, fl_w) > 0
    want = params_from_jax(unflatten(ref, "pl/sharded/final/"), cfg, "cpu",
                           training=True)
    for (k, x), (_, y) in zip(tree_lib.leaves_with_path(final),
                              tree_lib.leaves_with_path(want)):
        assert float((x - y).abs().max()) <= PARAM_DIFF_STEPS * 2.0 ** -fl_w, k


def _mlp_loss(params, batch, qctx=None):
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    return torch.mean((h @ params["w2"] - batch["y"]) ** 2), {}


def test_master_weights_keep_the_zero_params_leg_fp32(ref):
    params = {k: torch.from_numpy(MLP_ARRAYS[f"params/{k}"].copy())
              for k in MLP_SHAPES}
    batch = {k: torch.from_numpy(MLP_ARRAYS[k]) for k in ("x", "y")}
    opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    qcfg = qtrain.QuantConfig(rounding="nearest", grad_allreduce_bits=8,
                              zero_opt_shards=N, master_weights=True
                              ).with_per_layer_wire(params)
    tr = StackedTransport(N)
    assert not qtrain.wire_params_engaged(qcfg, params, tr)
    assert qtrain.wire_params_engaged(
        dataclasses.replace(qcfg, master_weights=False), params, tr)
    step = qtrain.make_train_step(_mlp_loss, opt, qcfg, transport=tr)
    assert step.zero_opt_active and step.wire_sync_active
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, tr, qcfg), qcfg, 3)
    hist = {k: [] for k in ("loss", "il_w", "fl_w", "il_g", "fl_g",
                            "il_wire_grads", "fl_wire_grads")}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(MLP_STEPS):
            state, m = step(state, batch)
            for k in hist:
                hist[k].append(float(m[k]))
    # the reference's step warns while it is traced (once a trace)
    zero = lambda msgs: {w for w in msgs if w.startswith("zero_opt_shards")}
    got = zero([str(w.message) for w in caught])
    assert got == zero(json.loads(str(ref["zm/warnings"])))
    assert len(got) == 1 and "master_weights is set" in got.pop()
    _hold(hist, ref, "zm/hist", rtol=MLP_LOSS_RTOL)
    # fp32 params leg and no re-snap: the parameters are off both grids
    assert _off_grid(state.params, hist["fl_w"][-1]) > 0
    for k in MLP_SHAPES:
        want = torch.from_numpy(ref[f"zm/final/{k}"])
        assert float((state.params[k] - want).abs().max()) <= (
            PARAM_DIFF_STEPS * 2.0 ** -hist["fl_g"][-1]), k


def test_standard_checkpoint_upgrades_into_an_extended_plan(ref, std,
                                                            tmp_path):
    state = std[1]
    ckpt.save(str(tmp_path), LENET["steps"], state, meta={"cursor": 4})
    ext = dataclasses.replace(_base(), precision_plan=_plans()["ext"])
    params = lenet_params_from_jax(unflatten(ref, "ln/params/"), "cpu")
    opt = _sgd()

    def template():
        return qtrain.TrainState.create(
            {k: torch.zeros_like(v) for k, v in params.items()},
            opt.init(params), ext, 1, "cpu")

    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), LENET["steps"], template())
    got, meta = ckpt.restore(str(tmp_path), LENET["steps"], template(),
                             defaults=qtrain.dps_restore_defaults(ext))
    assert meta == {"cursor": 4} and got.step == LENET["steps"]
    for k in state.params:
        assert torch.equal(got.params[k], state.params[k]), k
    saved, fresh = ckpt.flatten_tree(state), qtrain.dps_restore_defaults(ext)
    for k, v in ckpt.flatten_tree(got).items():
        if not k.startswith(".dps/"):
            continue
        domain = k.split("/")[1]
        want = saved[k] if domain in ("weights", "acts", "grads") else fresh[k]
        np.testing.assert_array_equal(v, want, err_msg=k)
    # the checkpoint's trajectories are not the fresh ones
    assert any(not np.array_equal(saved[k], fresh[k]) for k in saved
               if k.startswith((".dps/weights/", ".dps/grads/")))
