"""Long-context attention and ``remat="dots"`` in the port against the JAX
package's.

* ``_attn_flash`` (blockwise online softmax, each block checkpointed) at
  ``block=8`` against the reference's on fp32 inputs from a numpy seed —
  causal and not, fewer queries than keys, a last block padded, ``v``
  narrower than q/k: outputs within ``OUT_TOL`` and the gradients of
  ``sum(out * w)`` within ``GRAD_TOL`` (the same fp32 math summed in
  another order); and against the port's own ``_attn_full``, outputs and
  gradients.
* ``sdpa`` crossing the real ``FLASH_THRESHOLD`` at smoke width: smoke
  llama3.2-3b on one sequence of ``LONG_SEQ`` positions (S_q·S_k > 4096·
  2048), prefill logits and the unquantized loss and gradients against the
  reference, which goes blockwise there too.
* 3 SGD steps under nearest rounding with attention blockwise at every
  length (blocks of 8), and 3 with ``remat="dots"``: ⟨IL, FL⟩ of every
  domain identical at every step, the loss to ``LOSS_RTOL`` relative.
* The port's ``dots`` steps bit-equal to its ``full`` steps on one thread,
  with the same quantizer calls: the selective recompute, like the full
  one, stops before the tap.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, registry, transformer
from repro_torch.optim import SGDConfig, make_optimizer
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-4
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
BLOCK = 8
# (causal, B, Sq, Sk, H, Dh, Dv): a padded last block (20 = 2·8 + 4), fewer
# queries than keys (the causal offset), one block only, v narrower
FLASH_CASES = {"causal": (True, 2, 20, 20, 3, 16, 16),
               "full": (False, 2, 20, 20, 3, 16, 16),
               "offset": (True, 1, 12, 20, 2, 8, 8),
               "one_block": (True, 1, 5, 5, 2, 8, 8),
               "narrow_v": (True, 1, 17, 17, 2, 12, 8)}
LONG_SEQ = 3000                       # 3000² > FLASH_THRESHOLD = 8,388,608
LM = dict(steps=3, seq=20, batch=2)
CFG = smoke(get_config("llama3_2_3b"))


def _flash_arrays(case, seed):
    causal, B, Sq, Sk, H, Dh, Dv = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"q": f(B, Sq, H, Dh), "k": f(B, Sk, H, Dh), "v": f(B, Sk, H, Dv),
            "w": f(B, Sq, H, Dv)}


FLASH_ARRAYS = {c: _flash_arrays(c, 30 + i) for i, c in enumerate(FLASH_CASES)}
_rng = np.random.default_rng(40)
LONG_TOKENS = _rng.integers(1, CFG.vocab, (1, LONG_SEQ + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {"long/tokens": LONG_TOKENS}
    for case, arrs in FLASH_ARRAYS.items():
        jobs.append({"job": "flash", "tag": f"flash/{case}", "kw": {
            "block": BLOCK, "causal": FLASH_CASES[case][0]}})
        arrays.update({f"flash/{case}/{k}": v for k, v in arrs.items()})
    jobs += [{"job": "long", "tag": "long", "kw": {"seed": 0}},
             {"job": "lm_train", "tag": "lm_flash", "kw": dict(
                 LM, remat="full", flash_block=BLOCK)},
             {"job": "lm_train", "tag": "lm_dots", "kw": dict(
                 LM, seq=16, remat="dots")}]
    return run_reference(jobs, arrays)


def _flash_grads(fn, a, causal):
    q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in "qkv")
    scale = 1.0 / float(np.sqrt(a["q"].shape[-1]))
    out = fn(q, k, v, causal=causal, scale=scale)
    dq, dk, dv = torch.autograd.grad((out * torch.from_numpy(a["w"])).sum(),
                                     (q, k, v))
    return {"out": out.detach(), "dq": dq, "dk": dk, "dv": dv}


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attn_flash_matches_reference(ref, case):
    causal = FLASH_CASES[case][0]
    got = _flash_grads(partial(attention._attn_flash, block=BLOCK),
                       FLASH_ARRAYS[case], causal)
    assert got["out"].shape == FLASH_ARRAYS[case]["w"].shape
    assert _max_err(got["out"], ref[f"flash/{case}/flash/out"]) <= OUT_TOL
    for n in ("dq", "dk", "dv"):
        assert _max_err(got[n], ref[f"flash/{case}/flash/{n}"]) <= GRAD_TOL, n


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attn_flash_gradients_match_full_attention(ref, case):
    """The blockwise path against the materialized one, in the port and
    in the reference: the same outputs and gradients within tolerance."""
    causal = FLASH_CASES[case][0]
    a = FLASH_ARRAYS[case]
    flash = _flash_grads(partial(attention._attn_flash, block=BLOCK), a,
                         causal)
    full = _flash_grads(attention._attn_full, a, causal)
    for n in ("out", "dq", "dk", "dv"):
        tol = OUT_TOL if n == "out" else GRAD_TOL
        assert _max_err(flash[n], full[n]) <= tol, n
        assert _max_err(full[n], ref[f"flash/{case}/full/{n}"]) <= tol, n


def test_sdpa_goes_blockwise_above_the_threshold_and_matches_reference(
        ref, monkeypatch):
    calls = []
    real = attention._attn_flash
    monkeypatch.setattr(attention, "_attn_flash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert LONG_SEQ * LONG_SEQ > attention.FLASH_THRESHOLD
    params = params_from_jax(unflatten(ref, "long/params/"), CFG, "cpu")
    toks = torch.from_numpy(LONG_TOKENS)
    logits, _, _ = transformer.prefill(CFG, params, toks[:, :-1], LONG_SEQ)
    assert len(calls) == CFG.n_layers
    assert _max_err(logits, ref["long/prefill_logits"]) <= LOGIT_TOL
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    loss, _ = transformer.loss_fn(CFG)(tree_lib.from_leaves(params, leaves),
                                       {"tokens": toks})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref["long/loss"]),
                               rtol=LOSS_RTOL)
    want = unflatten(ref, "long/grads/")
    for (path, _), g in zip(tree_lib.leaves_with_path(params), grads):
        w = want
        for k in path:
            w = w[k]
        scale = max(float(np.max(np.abs(w))), 1e-12)
        assert _max_err(g, w) <= GRAD_TOL * scale, path


def _lm_hist(ref, tag, cfg, seq):
    params = params_from_jax(unflatten(ref, f"{tag}/params/"), cfg, "cpu",
                             training=True)
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(cfg.family).loss_fn(cfg), opt,
                                  qcfg)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=LM["batch"], seed=0))
    hist = {k: [] for k in FMTS + ("loss",)}
    for i in range(LM["steps"]):
        state, m = step(state, data.batch(i))
        for k in hist:
            hist[k].append(float(m[k]))
    return hist


def _hold(hist, ref, tag):
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"{tag}/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref[f"{tag}/hist/loss"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(hist["loss"]))


def test_lm_steps_through_the_blockwise_path_match_reference(ref, monkeypatch):
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", 0)
    monkeypatch.setattr(attention, "_attn_flash",
                        partial(attention._attn_flash, block=BLOCK))
    cfg = dataclasses.replace(CFG, remat="full")
    _hold(_lm_hist(ref, "lm_flash", cfg, LM["seq"]), ref, "lm_flash")


def test_dots_lm_steps_match_reference(ref):
    cfg = dataclasses.replace(CFG, remat="dots")
    _hold(_lm_hist(ref, "lm_dots", cfg, 16), ref, "lm_dots")


def _counted_steps(remat, monkeypatch, steps=2):
    """``steps`` CLI-built steps of smoke llama under ``remat`` (stochastic
    rounding, the trainer's defaults): the metrics and the quantizer calls
    a step."""
    calls = []
    real = ops.dps_quantize
    monkeypatch.setattr(ops, "dps_quantize",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = train_cli.make_parser().parse_args(
        ["--arch", "llama3_2_3b", "--device", "cpu", "--steps",
         str(steps), "--batch", "2", "--seq", "16", "--optimizer", "sgd"])
    cfg = dataclasses.replace(CFG, remat=remat)
    _, step_fn, state, data = train_cli.setup(args, cfg)
    hist, per_step = [], []
    for i in range(steps):
        n = len(calls)
        state, m = step_fn(state, data.batch(i))
        hist.append({k: float(v) for k, v in m.items()})
        per_step.append(len(calls) - n)
    return hist, per_step, tree_lib.leaves(state.params)


def test_dots_steps_bit_equal_full_steps(one_thread, monkeypatch):
    """``remat="dots"`` keeps the matrix products' outputs where ``full``
    recomputes them: on one thread the two give the same numbers bit for
    bit, and the same quantizer calls a step (the tap, which saves no
    tensor, is not recomputed under either)."""
    runs = {r: _counted_steps(r, monkeypatch) for r in ("full", "dots")}
    (h_full, n_full, p_full), (h_dots, n_dots, p_dots) = runs.values()
    assert h_dots == h_full
    assert n_dots == n_full
    for a, b in zip(p_full, p_dots):
        assert torch.equal(a, b)
    # 3 x the 8 quantized leaves + one tap a layer forward and backward
    assert n_full == [3 * 8 + 2 * CFG.n_layers] * 2


def test_dots_saves_the_matrix_products(monkeypatch):
    """The selective policy saves the outputs of mm/bmm/addmm and
    recomputes the rest: a backward under ``dots`` runs no matrix product
    of the forward again, one under ``full`` runs every one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in transformer._DOT_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.common import init_params
    params = init_params(transformer.model_defs(CFG, torch.float32), "cpu",
                         gen)
    toks = torch.from_numpy(LONG_TOKENS[:, :9].astype(np.int64))
    counts = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(CFG, remat=remat)
        hidden, _, _ = transformer.forward_train(
            cfg, tree_lib.map_tree(lambda p: p.requires_grad_(), params),
            toks)
        with Count() as c:
            hidden.sum().backward()
        counts[remat] = c.n
    assert counts["dots"] == counts["none"] < counts["full"]
