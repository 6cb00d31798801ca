"""The port's quantized training step against the JAX package's.

From the same numpy parameters (the reference's, converted by
``repro_torch.convert``) and the same numpy data, under nearest rounding (the
random bits of stochastic rounding cannot be reproduced across frameworks):

* the activation tap (``QCtx.tap``, an ``autograd.Function`` here, a
  ``custom_vjp`` there): forward q and backward gradient bit-equal, the
  statistics as for the quantizer (integer ones exact, sums to 1e-6);
* LeNet through ``apps.mnist.train_mnist`` and the paper's controller, 5
  steps, and the smoke-size llama3.2-3b through ``make_train_step`` with SGD
  and full remat, 3 steps: ⟨IL, FL⟩ of every domain identical at every step,
  the loss to 1e-4 relative (fp32 convolutions and matrix products summed in
  another order; a grid value that lands on a rounding boundary in one
  framework and not the other would move a weight by one grid step, and the
  loss by far less than that).

Also: the training CLI on the CPU, remat's recompute drawing the same bits
and counting its statistics once, and the layer stack split by one
``unbind`` instead of one select per layer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.apps import mnist as app
from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import lenet_params_from_jax, params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import FixedPointFormat
from repro_torch.data import MNISTLike, TokenStream, TokenStreamConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import registry, transformer
from repro_torch.models.common import init_params
from repro_torch.optim import SGDConfig, make_optimizer
from repro_torch.resilience import GuardConfig
from test_torch_jaxref import (STAT_NAMES, one_thread,  # noqa: F401
                               run_reference, unflatten)

CFG = dataclasses.replace(smoke(get_config("llama3_2_3b")), remat="full")
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
LOSS_RTOL = 1e-4
# At the paper's initial ⟨8, 12⟩ the logit tap's E (a mean relative error,
# dominated by the logits nearest zero) sits close to e_max at step 0, while
# the two frameworks' fp32 convolutions, summed in other orders, land some
# earlier activations on the other side of a rounding boundary: the first FL
# decision then goes either way.  From FL = 6 the decisions of these 5 steps
# are clear of their thresholds.
LENET = dict(steps=5, n_train=256, qkw={"fl_init": 6})
LM = dict(steps=3, seq=16, batch=2)

_rng = np.random.default_rng(8)
TAP = {"x": (_rng.standard_normal((4, 33)) * 3).astype(np.float32),
       "cot": (_rng.standard_normal((4, 33)) * 1e-2).astype(np.float32)}
TAP_KW = {"acts": [4, 6], "grads": [3, 12], "salt": 3}


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "qtap", "tag": "tap", "kw": TAP_KW},
            {"job": "lenet_train", "tag": "lenet", "kw": LENET},
            {"job": "lm_train", "tag": "lm", "kw": dict(LM, remat="full")}]
    return run_reference(jobs, {f"tap/{k}": v for k, v in TAP.items()})


def test_tap_forward_and_backward_match_the_custom_vjp(ref):
    qctx = qtrain.QCtx(acts_fmt=FixedPointFormat.create(*TAP_KW["acts"]),
                       grads_fmt=FixedPointFormat.create(*TAP_KW["grads"]),
                       seed=0, rounding="nearest", collect_stats=True)
    x = torch.from_numpy(TAP["x"]).requires_grad_()
    q, s = qctx.tap(x, TAP_KW["salt"])
    q.backward(torch.from_numpy(TAP["cot"]))
    np.testing.assert_array_equal(q.detach().numpy(), ref["tap/q"])
    np.testing.assert_array_equal(x.grad.numpy(), ref["tap/g"])
    for k in STAT_NAMES:
        got, want = float(getattr(s, k)), float(ref[f"tap/{k}"])
        if k in ("count", "nonzero", "overflow", "max_abs"):
            assert got == want, k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
    assert not getattr(s.count, "requires_grad", False)


def _hold_history(hist, ref, tag, steps):
    for k in FMTS:
        got = np.asarray(hist[k], np.float64)
        np.testing.assert_array_equal(got, ref[f"{tag}/hist/{k}"][:steps],
                                      err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref[f"{tag}/hist/loss"],
                               rtol=LOSS_RTOL)


def test_lenet_steps_match_reference_from_converted_params(ref):
    """The paper's app, from the reference's own initial parameters: the
    first-step loss and then every step's formats and loss agree."""
    params = lenet_params_from_jax(unflatten(ref, "lenet/params/"), "cpu")
    assert params["conv2_w"].shape == (50, 20, 5, 5)
    data = MNISTLike(batch=64, seed=0, n_train=LENET["n_train"], n_test=64)
    hist = app.train_mnist(app.paper_quant_config(rounding="nearest",
                                                  **LENET["qkw"]),
                           steps=LENET["steps"], data=data, device="cpu",
                           params=params)
    _hold_history(hist, ref, "lenet", LENET["steps"])
    # the controllers moved: the comparison is not of constants
    assert len(set(hist["il_w"])) > 1


def test_lm_steps_match_reference_from_converted_params(ref):
    """Smoke llama3.2-3b, fp32 master parameters, full remat, SGD."""
    params = params_from_jax(unflatten(ref, "lm/params/"), CFG, "cpu",
                             training=True)
    assert all(p.dtype == torch.float32 for p in tree_lib.leaves(params))
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG), opt, qcfg)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=LM["seq"],
                                         global_batch=LM["batch"], seed=0))
    hist = {k: [] for k in FMTS + ("loss",)}
    for i in range(LM["steps"]):
        state, m = step(state, data.batch(i))
        for k in hist:
            hist[k].append(float(m[k]))
    assert state.step == LM["steps"]
    _hold_history(hist, ref, "lm", LM["steps"])


def _stochastic_qctx(seed=9):
    return qtrain.QCtx(acts_fmt=FixedPointFormat.create(6, 10),
                       grads_fmt=FixedPointFormat.create(6, 14), seed=seed,
                       rounding="stochastic", collect_stats=True,
                       onchip_prng=True)


def _smoke_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_params(transformer.model_defs(cfg, cfg.master_dtype()), "cpu",
                       gen)


def test_remat_redraws_the_same_bits_and_counts_stats_once(one_thread):
    """Full remat recomputes each block in the backward: the seeds are host
    integers, so the recompute rounds exactly as the forward did, and the
    statistics leave the block as values, so they are counted once."""
    params = _smoke_params(CFG)
    tokens = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=8,
                                           global_batch=2)).batch(0)
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(CFG, remat=remat)
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree_lib.leaves(params)]
        loss, aux = transformer.loss_fn(cfg)(
            tree_lib.from_leaves(params, leaves), tokens, _stochastic_qctx())
        out[remat] = (loss, aux["act_stats"], torch.autograd.grad(loss, leaves))
    (l0, s0, g0), (l1, s1, g1) = out["none"], out["full"]
    assert torch.equal(l0, l1)
    assert float(s1.count) == CFG.n_layers * 2 * 8 * CFG.d_model
    for k in STAT_NAMES:
        assert torch.equal(getattr(s0, k), getattr(s1, k)), k
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def _graph_nodes(t):
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack += [f for f, _ in fn.next_functions]
    return names


def test_layer_stack_is_split_by_one_unbind_per_leaf():
    """Each stacked leaf reaches the layers through ONE unbind, whose
    backward stacks the per-layer gradients once; a select per layer would
    give every layer a full stacked-size zero-filled gradient to add up."""
    cfg = dataclasses.replace(CFG, remat="none")
    params = tree_lib.map_tree(lambda p: p.requires_grad_(), _smoke_params(cfg))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    hidden, _, _ = transformer.forward_train(cfg, params, tokens)
    names = _graph_nodes(hidden.sum())
    n_stacked = len(tree_lib.leaves(params["layers"]))
    assert names.count("UnbindBackward0") == n_stacked
    assert "SelectBackward0" not in names
    # and the gradient of a stacked leaf equals the per-layer sum it replaces
    hidden.sum().backward()
    g = params["layers"]["mlp"]["w_in"].grad
    assert g.shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_chunked_unembed_xent_equals_the_full_softmax_xent():
    """The chunked, checkpointed loss gives the full-logits loss and its
    gradients, with a mask and a last chunk shorter than the others."""
    from repro_torch.models.common import (fused_unembed_xent, softmax_xent,
                                           unembed)
    g = torch.Generator().manual_seed(1)
    table = torch.randn(CFG.vocab, CFG.d_model, generator=g)
    x = torch.randn(2, 11, CFG.d_model, generator=g)
    labels = torch.randint(0, CFG.vocab, (2, 11), generator=g)
    mask = (torch.rand(2, 11, generator=g) > 0.3).to(torch.float32)
    out = []
    for fused in (True, False):
        xr, tr = x.clone().requires_grad_(), table.clone().requires_grad_()
        p = {"tok": tr}
        loss = (fused_unembed_xent(xr, p, CFG.vocab, labels, mask, chunk=4)
                if fused else
                softmax_xent(unembed(xr, p, CFG.vocab), labels, mask))
        out.append((loss, *torch.autograd.grad(loss, (xr, tr))))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_gradient_accumulation_runs_microbatches():
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    params = _smoke_params(CFG)
    loss = registry(CFG.family).loss_fn(CFG)
    step = qtrain.make_train_step(loss, opt, qcfg, accum_steps=2)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=CFG.vocab, seq_len=8,
                                         global_batch=4))
    state, m = step(state, data.batch(0))
    assert np.isfinite(float(m["loss"])) and state.step == 1
    with pytest.raises(ValueError, match="microbatches"):
        step(state, TokenStream(TokenStreamConfig(
            vocab=CFG.vocab, seq_len=8, global_batch=3)).batch(0))


@pytest.mark.parametrize("field,value", [("zero_opt_shards", 2),
                                         ("wire_overlap", True),
                                         ("guards", GuardConfig())])
def test_unported_training_switches_raise(field, value):
    """Every one of the reference's switches on the training step is
    ported now, and none raises on its own: ZeRO-1, the overlapped wire and
    the health guards construct, and with no transport (one rank) the step
    is the replicated one (the guards armed on it).  The combinations the
    port leaves out raise in ``tests/test_torch_resilience.py``."""
    qcfg = qtrain.QuantConfig(**{field: value})
    step = qtrain.make_train_step(registry(CFG.family).loss_fn(CFG),
                                  make_optimizer(SGDConfig()), qcfg)
    assert not (step.zero_opt_active or step.wire_overlap_active
                or step.wire_sync_active)
    assert step.guards_active == (field == "guards")


def test_train_cli_smoke_on_the_cpu(capsys):
    out = train_cli.main(["--arch", "llama3_2_3b", "--smoke", "--device", "cpu",
                          "--steps", "3", "--batch", "2", "--seq", "8",
                          "--log-every", "1", "--optimizer", "sgd"])
    text = capsys.readouterr().out
    assert text.count("loss") >= 3 and "w<" in text and "g<" in text
    assert len(out["history"]) == 3 and np.isfinite(out["final_loss"])
    assert out["device"] == "cpu" and out["peak_memory_bytes"] is None
    # on the CPU the plain versions run: no kernel launch is counted
    assert out["quantizer_launches_per_step"] == [0, 0, 0]


def test_train_cli_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "llama3_2_3b", "--smoke", "--steps", "1"])


def test_lenet_turns_tf32_off_only_while_it_trains():
    """LeNet runs its CUDA products in full fp32; the TF32 switches are
    process-wide, so they are put back when training ends (or raises)."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(KeyError):
            with app._full_fp32(torch.device("cuda")):
                assert not any(f.allow_tf32 for f in flags)
                raise KeyError("raised inside")
        assert all(f.allow_tf32 for f in flags)
        with app._full_fp32(torch.device("cpu")):
            assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
