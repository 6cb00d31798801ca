"""The SSM and hybrid families (Mamba2: mamba2-1.3b; Mamba2 with one shared
attention block: zamba2-7b) in the port against the JAX package's, from
the same weights.  Held, in fp32 at smoke size, within ``TOL``:

* every field of both configs and their full-size parameter counts equal
  to the reference's; ``params_from_jax`` keeps every leaf's layout
  (``conv_w`` (K, C) untransposed);
* ``ssd_scan`` at a length that is not a multiple of the chunk, without and
  with an initial state; ``_causal_conv`` without and with the decode tail;
  ``ssm_apply`` in train, prefill and decode mode;
* at the configs' own chunk (256) and initialization (``a_log = dt_bias =
  0``), where the chunk's decays sum past fp32's exponent range: the
  reference's ``ssm_apply`` is NaN, the port's is finite, equal to the O(1)
  recurrence run token by token within ``RECUR_RTOL`` of the largest
  magnitude, and its gradient finite;
* mamba2 and zamba2 (5 blocks every 2: two shared invocations and a
  remainder): prefill logits and caches, and 3 decode steps from the
  reference's prefill cache, their logits and the caches after them
  (zamba2's attention caches at ``kv_cache_bits`` 16 and 8; int8 entries
  bit-equal but where the value packed sits within 32·TOL of a rounding
  boundary, where the other summation order may take the neighbour: at
  smoke size one K entry of 3,072 does); the port's decode after its own
  prefill equals its prefill of one more token;
* the same at the bf16 working dtype from the reference's bf16 weights:
  the port's prefill and first decode step no further from its fp32 run
  of the same weights, nor from the reference's bf16, than
  ``BF16_DRIFT_RATIO`` times the reference's own bf16-to-fp32 distance;
* 3 SGD steps under nearest rounding over each config's 2 microbatches:
  ⟨IL, FL⟩ of every domain identical at every step, the loss to
  ``LOSS_RTOL`` relative;
* a step's quantizer events: 3 per quantized leaf plus a tap per block
  forward and backward for each microbatch — under full remat the
  recompute does not run the tap again (the count ``chip_smoke.py`` holds
  the card's K1b launches to); the training CLI on the CPU; the serving
  CLI refuses both families with the reference's message.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import hybrid, mamba, registry, ssm
from repro_torch.models.common import init_params
from repro_torch.optim import SGDConfig, make_optimizer
from test_torch_jaxref import run_reference, unflatten

ARCHS = ("mamba2_1_3b", "zamba2_7b")
# zamba2 at smoke width with 5 blocks, a shared block every 2: G = 2 shared
# invocations and a remainder of 1, the structure of 81 = 13 x 6 + 3
OVERRIDES = {"mamba2_1_3b": {}, "zamba2_7b": {"n_layers": 5}}
FULL_PARAMS = {"mamba2_1_3b": 1_343_740_928, "zamba2_7b": 6_636_442_832}
TOL = 1e-4
LOSS_RTOL = 1e-4
# the chunked scan against the O(1) recurrence at chunk 256, fp32: the same
# state sums taken in another order over 300 steps (measured 5.1e-6
# relative to the largest magnitude)
RECUR_RTOL = 5e-5
# the port's bf16 logits from the same weights as the reference's: their
# distance from the port's fp32 logits, and from the reference's bf16
# ones, each at most this many times the reference's own distance from its
# fp32 logits (both bf16 paths round the same products in other orders;
# measured 0.86-1.28x at smoke size)
BF16_DRIFT_RATIO = 2.0
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
MAX_SEQ = 12
# 3 steps of 4 sequences over the configs' 2 microbatches
LM = dict(steps=3, seq=16, batch=4, remat="full")
# fp32's exponent range: exp(x) overflows above log(FLT_MAX)
F32_EXP_MAX = math.log(np.finfo(np.float32).max)


def _cfg(arch, **kw):
    return dataclasses.replace(smoke(get_config(arch)),
                               **OVERRIDES[arch], **kw)


def _accum(arch):
    return {"train_accum": get_config(arch).train_accum}


_rng = np.random.default_rng(22)
_S = _cfg("mamba2_1_3b")
_H, _P, _N = ssm.n_ssm_heads(_S), _S.ssm_head_dim, _S.ssm_state
_C, _K, _D = ssm.conv_channels(_S), _S.ssm_conv, _S.d_model


def _f32(*shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _ssm_arrays():
    """ssd_scan inputs at 13 positions (chunk 8), conv inputs, and a mixer's
    parameters with decays well inside the range."""
    B, S = 2, 13
    dt = np.log1p(np.exp(_f32(B, S, _H))).astype(np.float32)
    a = {"x": _f32(B, S, _H, _P), "b": _f32(B, S, _N), "c": _f32(B, S, _N),
         "dt": dt, "ld": (-dt * np.exp(_f32(B, S, _H, scale=0.5))
                          ).astype(np.float32),
         "h0": _f32(B, _H, _P, _N),
         "xbc": _f32(B, 5, _C), "w": _f32(_K, _C, scale=0.5),
         "cb": _f32(_C, scale=0.1), "tail": _f32(B, _K - 1, _C),
         "u": _f32(B, 11, _D), "u256": _f32(1, 300, _D)}
    n_in = 2 * ssm.d_inner(_S) + 2 * _N + _H
    p = {"w_in": _f32(_D, n_in, scale=_D ** -0.5),
         "conv_w": _f32(_K, _C, scale=0.5), "conv_b": _f32(_C, scale=0.1),
         "a_log": _f32(_H, scale=0.5), "dt_bias": _f32(_H, scale=0.5),
         "d_skip": _f32(_H, scale=0.5) + 1,
         "norm_scale": _f32(ssm.d_inner(_S), scale=0.1) + 1,
         "w_out": _f32(ssm.d_inner(_S), _D, scale=ssm.d_inner(_S) ** -0.5)}
    a.update({f"p/{k}": v for k, v in p.items()})
    return a


SSM = _ssm_arrays()
N_PROMPT = 10
MODEL = {"tokens": _rng.integers(1, 256, (2, 8)).astype(np.int32),
         "steps": _rng.integers(1, 256, (2, 3)).astype(np.int32)}
DRIFT = {"tokens": _rng.integers(1, 256, (2, 32)).astype(np.int32),
         "step": _rng.integers(1, 256, (2, 1)).astype(np.int32)}
DRIFT_SEQ = 40


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "config", "tag": "cfg", "kw": {"archs": list(ARCHS)}},
            {"job": "ssm", "tag": "ssm",
             "kw": {"overrides": {}, "n_prompt": N_PROMPT}}]
    arrays = {f"ssm/{k}": v for k, v in SSM.items()}
    for arch in ARCHS:
        jobs += [{"job": "decode_model", "tag": f"{arch}/model", "kw": dict(
                     seed=0, arch=arch, max_seq=MAX_SEQ,
                     overrides=OVERRIDES[arch],
                     bits=[16, 8] if arch == "zamba2_7b" else [16])},
                 {"job": "lm_train", "tag": f"{arch}/lm", "kw": dict(
                     LM, arch=arch, overrides=dict(OVERRIDES[arch],
                                                   **_accum(arch)))},
                 {"job": "serve_refusal", "tag": f"{arch}/serve",
                  "kw": {"arch": arch}},
                 {"job": "bf16_drift", "tag": f"{arch}/drift", "kw": dict(
                     seed=1, arch=arch, max_seq=DRIFT_SEQ,
                     overrides=OVERRIDES[arch])}]
        arrays.update({f"{arch}/model/{k}": v for k, v in MODEL.items()})
        arrays.update({f"{arch}/drift/{k}": v for k, v in DRIFT.items()})
    return run_reference(jobs, arrays)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= TOL, (what, np.max(np.abs(got - want)))


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_full_size_counts_match_reference(ref, arch):
    cfg = get_config(arch)
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == json.loads(
        str(ref[f"cfg/{arch}/fields"]))
    assert cfg.n_params() == float(ref[f"cfg/{arch}/n_params"]) \
        == FULL_PARAMS[arch]
    assert registry(cfg.family) is (mamba if arch == "mamba2_1_3b" else hybrid)
    # smoke() derives the reduced SSM fields as the reference's does
    s = smoke(cfg)
    assert (s.ssm_state, s.ssm_head_dim, s.ssm_chunk, s.hybrid_period) == (
        16, 16, 8, 2 if cfg.hybrid_period else 0)


def test_params_from_jax_keeps_every_layout(ref):
    cfg = _cfg("zamba2_7b")
    tree = unflatten(ref, "zamba2_7b/model/params/")
    params = params_from_jax(tree, cfg, "cpu")
    for path, leaf in tree_lib.leaves_with_path(params):
        node = tree
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(leaf.numpy(), node, err_msg=str(path))
    s = params["mamba"]["ssm"]
    assert s["conv_w"].shape == (cfg.n_layers, cfg.ssm_conv,
                                 ssm.conv_channels(cfg))
    assert params["shared"]["attn"]["wq"].ndim == 2      # one shared block


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h0", [False, True])
def test_ssd_scan_matches_reference_off_the_chunk_grid(ref, h0):
    a = {k: _t(v) for k, v in SSM.items()}
    assert a["x"].shape[1] % _S.ssm_chunk
    name = "scan_h0" if h0 else "scan"
    y, h = ssm.ssd_scan(_S, a["x"], a["b"], a["c"], a["dt"], a["ld"],
                        a["h0"] if h0 else None)
    _close(y, ref[f"ssm/{name}/y"], "y")
    _close(h, ref[f"ssm/{name}/h"], "h")


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_reference(ref, tail):
    a = {k: _t(v) for k, v in SSM.items()}
    name = "conv_tail" if tail else "conv"
    y, st = ssm._causal_conv(a["xbc"], a["w"], a["cb"],
                             a["tail"] if tail else None)
    _close(y, ref[f"ssm/{name}/y"], "y")
    _close(st, ref[f"ssm/{name}/state"], "state")


def _mixer_params():
    return {k[2:]: _t(v) for k, v in SSM.items() if k.startswith("p/")}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_apply_matches_reference(ref, mode):
    p, u = _mixer_params(), _t(SSM["u"])
    if mode == "train":
        y, cache = ssm.ssm_apply(_S, p, u, mode="train")
        assert cache is None
    else:
        y, cache = ssm.ssm_apply(_S, p, u[:, :N_PROMPT], mode="prefill")
        if mode == "decode":
            y, cache = ssm.ssm_apply(_S, p, u[:, N_PROMPT:N_PROMPT + 1],
                                     mode="decode", cache=cache)
        _close(cache[0], ref[f"ssm/{mode}/h"], "state")
        _close(cache[1], ref[f"ssm/{mode}/tail"], "tail")
    _close(y, ref[f"ssm/{mode}/y"], "y")


def test_chunk_256_reference_is_nan_and_the_port_equals_the_recurrence(ref):
    """The configs' chunk and initialization: the reference's intra-chunk
    ``exp(rel) * tril`` overflows above the diagonal and gives NaN; the
    port's masked exponent does not."""
    cfg = _cfg("mamba2_1_3b", ssm_chunk=256)
    p = {k: _t(v) for k, v in unflatten(ref, "ssm/init/").items()}
    assert not bool(p["a_log"].any()) and not bool(p["dt_bias"].any())
    u = _t(SSM["u256"]).requires_grad_()
    # the first chunk's decays sum past fp32's exponent range
    dt, _ = ssm._decays(cfg, ssm._split_proj(cfg, u.detach() @ p["w_in"])[2],
                        p["a_log"], p["dt_bias"])
    assert float(dt[0, :256].sum(0).max()) > F32_EXP_MAX
    assert np.isnan(ref["ssm/chunk256/y"]).any()

    y, _ = ssm.ssm_apply(cfg, p, u, mode="train")
    assert bool(torch.isfinite(y).all())
    cache = (torch.zeros(1, _H, _P, _N), torch.zeros(1, _K - 1, _C))
    steps = []
    with torch.no_grad():
        for t in range(u.shape[1]):
            out, cache = ssm.ssm_apply(cfg, p, u[:, t:t + 1], mode="decode",
                                       cache=cache)
            steps.append(out)
    rec = torch.cat(steps, dim=1)
    err = float((y.detach() - rec).abs().max())
    assert err <= RECUR_RTOL * float(rec.abs().max()), err
    y.square().sum().backward()
    assert bool(torch.isfinite(u.grad).all()) and bool(u.grad.any())


# ---------------------------------------------------------------------------
# the models: prefill, decode, training
# ---------------------------------------------------------------------------

def _cache_flat(cache):
    if isinstance(cache, (tuple, list)):
        cache = {str(i): c for i, c in enumerate(cache)}
    if isinstance(cache, dict):
        return {f"{k}/{n}" if n else k: v for k, c in cache.items()
                for n, v in _cache_flat(c).items()}
    return {"": cache}


def _flat_np(cache):
    return {k: v.to(torch.float32).numpy() for k, v in _cache_flat(cache).items()}


def _hold_int8(got, want, twin, what):
    """Int8 caches (as fp32 arrays) bit-equal, but where the value packed —
    ``twin``, the port's fp32 run of the same computation — lies within
    32·TOL of a rounding boundary of the ⟨3, 5⟩ grid: there the reference's
    fp32 sums, taken in another order, may round to the neighbour (one grid
    step; ROADMAP's known reference artefacts)."""
    off = got != want
    if off.any():
        assert np.abs(got - want)[off].max() == 1, what
        t = twin[off] * 32
        assert np.abs(np.abs(t - np.floor(t)) - 0.5).max() <= 32 * TOL, what


def hold_caches(cache, ref, prefix, twin=None):
    """``cache`` against the reference's under ``prefix``: fp32 leaves
    within ``TOL``, int8 ones by :func:`_hold_int8` against ``twin`` (the
    same cache from the port's fp32 run)."""
    got = _flat_np(cache)
    want = {"/".join(k): v for k, v in
            tree_lib.leaves_with_path(unflatten(ref, prefix))}
    assert sorted(got) == sorted(want)
    for key, v in _cache_flat(cache).items():
        if v.dtype == torch.int8:
            _hold_int8(got[key], want[key], twin[key], key)
        else:
            assert v.dtype == torch.float32, key
            _close(v, want[key], key)


def ref_cache(ref, prefix, like):
    """The reference's cache under ``prefix`` as tensors shaped and typed
    like the port's ``like``."""
    want = {"/".join(k): v for k, v in
            tree_lib.leaves_with_path(unflatten(ref, prefix))}
    flat = _cache_flat(like)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(build(v, path + (str(i),)) for i, v in enumerate(node))
        key = "/".join(path)
        return _t(want[key]).to(flat[key].dtype)

    return build(like, ())


def dequantized(cache):
    """An int8 cache's values in fp32 (the port's ``kv_cache_bits`` 16 run
    of the same steps reads the same numbers)."""
    if isinstance(cache, dict):
        return {k: dequantized(v) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(dequantized(v) for v in cache)
    return (cache.to(torch.float32) / 32 if cache.dtype == torch.int8
            else cache.clone())


def check_prefill(ref, arch, cfg, params, tokens, extra=None):
    """Prefill logits and caches against the reference's (int8 ones by the
    port's fp32 twin at ``kv_cache_bits`` 16)."""
    mod, bits = registry(cfg.family), cfg.kv_cache_bits
    logits, cache, _ = mod.prefill(cfg, params, tokens, MAX_SEQ, **(extra or {}))
    want = mod.init_cache(cfg, tokens.shape[0], MAX_SEQ, "cpu")
    assert [(c.shape, c.dtype) for c in _cache_flat(cache).values()] == \
        [(c.shape, c.dtype) for c in _cache_flat(want).values()]
    _close(logits, ref[f"{arch}/model/{bits}/prefill_logits"], "prefill")
    twin = None
    if bits == 8:
        twin = _flat_np(mod.prefill(dataclasses.replace(cfg, kv_cache_bits=16),
                                    params, tokens, MAX_SEQ,
                                    **(extra or {}))[1])
    hold_caches(cache, ref, f"{arch}/model/{bits}/prefill_cache/", twin)
    return cache


def check_decode(ref, arch, cfg, params, steps, pos):
    """3 decode steps from the reference's prefill cache: each step's
    logits, and the cache after them (int8 by the fp32 twin: the same steps
    on the dequantized cache at ``kv_cache_bits`` 16)."""
    mod, bits = registry(cfg.family), cfg.kv_cache_bits
    like = mod.init_cache(cfg, steps.shape[0], MAX_SEQ, "cpu")
    cache = ref_cache(ref, f"{arch}/model/{bits}/prefill_cache/", like)
    twin_cfg = dataclasses.replace(cfg, kv_cache_bits=16)
    twin = dequantized(cache) if bits == 8 else None
    for i in range(steps.shape[1]):
        tok = steps[:, i:i + 1]
        lg, new = mod.decode_step(cfg, params, tok, cache, pos)
        assert new is cache                     # written in place
        if twin is not None:
            mod.decode_step(twin_cfg, params, tok, twin, pos)
        pos = pos + 1
        _close(lg, ref[f"{arch}/model/{bits}/decode_logits/{i}"], f"step {i}")
    hold_caches(cache, ref, f"{arch}/model/{bits}/decode_cache/",
                None if twin is None else _flat_np(twin))
    return cache


CASES = [("mamba2_1_3b", 16), ("zamba2_7b", 16), ("zamba2_7b", 8)]


def _model_params(ref, arch, cfg):
    return params_from_jax(unflatten(ref, f"{arch}/model/params/"), cfg, "cpu")


@pytest.mark.parametrize("arch,bits", CASES)
def test_prefill_matches_reference(ref, arch, bits):
    cfg = _cfg(arch, kv_cache_bits=bits)
    check_prefill(ref, arch, cfg, _model_params(ref, arch, cfg),
                  _t(MODEL["tokens"]))


@pytest.mark.parametrize("arch,bits", CASES)
def test_decode_steps_match_reference(ref, arch, bits):
    cfg = _cfg(arch, kv_cache_bits=bits)
    tokens = MODEL["tokens"]
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32)
    check_decode(ref, arch, cfg, _model_params(ref, arch, cfg),
                 _t(MODEL["steps"]), pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_the_longer_forward(ref, arch):
    """The port's own chain: prefill S tokens, decode the next; its logits
    equal the prefill of S + 1 tokens' last."""
    cfg = _cfg(arch)
    mod = registry(cfg.family)
    params = _model_params(ref, arch, cfg)
    tokens = _t(np.concatenate([MODEL["tokens"], MODEL["steps"][:, :1]], 1))
    _, cache, pos = mod.prefill(cfg, params, tokens[:, :-1], MAX_SEQ)
    lg, _ = mod.decode_step(cfg, params, tokens[:, -1:], cache, pos)
    full, _, _ = mod.prefill(cfg, params, tokens, MAX_SEQ)
    assert float((lg - full).abs().max()) <= TOL


def _train(cfg, params, steps, extras=None):
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(registry(cfg.family).loss_fn(cfg), opt,
                                  qcfg, accum_steps=cfg.train_accum)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=LM["seq"],
                                         global_batch=LM["batch"], seed=0),
                       extras=extras)
    hist = {k: [] for k in FMTS + ("loss",)}
    for i in range(steps):
        state, m = step(state, data.batch(i))
        for k in hist:
            hist[k].append(float(m[k]))
    return hist


def hold_bf16_drift(ref, arch, cfg, drift, extra=None):
    """The port's prefill and first decode step from the reference's bf16
    weights (``{arch}/drift``), at the bf16 working dtype and with the same
    weights cast up to fp32: fp32 within ``TOL`` of the reference's fp32,
    and bf16 no further from the port's fp32, nor from the reference's
    bf16, than ``BF16_DRIFT_RATIO`` times the reference's own bf16 from its
    fp32: a fault that only shows in bf16 fails here once it moves the
    logits past bf16's own rounding.  One rounding more does not: an fp32
    island run in bf16 (LayerNorm or RMSNorm without their fp32 upcast,
    dt's softplus in bf16) passes at smoke size."""
    mod, V = registry(cfg.family), cfg.vocab
    src = unflatten(ref, f"{arch}/drift/params/")
    got = {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        params = params_from_jax(src, c, "cpu")
        with torch.no_grad():
            logits, cache, pos = mod.prefill(c, params, _t(drift["tokens"]),
                                             DRIFT_SEQ, **(extra or {}))
            lg, _ = mod.decode_step(c, params, _t(drift["step"]), cache, pos)
        got[dt] = {"prefill_logits": logits, "decode_logits": lg}
    for what in ("prefill_logits", "decode_logits"):
        r16, r32 = (ref[f"{arch}/drift/{dt}/{what}"][..., :V]
                    for dt in ("bfloat16", "float32"))
        p16, p32 = (got[dt][what].float().numpy()[..., :V]
                    for dt in ("bfloat16", "float32"))
        _close(p32, r32, f"{what} fp32")
        big = np.abs(r32).max()
        ref_drift = np.abs(r16 - r32).max() / big
        assert ref_drift > 0, what               # the control is live
        limit = BF16_DRIFT_RATIO * ref_drift
        port_drift = np.abs(p16 - p32).max() / np.abs(p32).max()
        apart = np.abs(p16 - r16).max() / big
        assert port_drift <= limit, (what, port_drift, ref_drift)
        assert apart <= limit, (what, apart, ref_drift)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_drift_matches_reference(ref, arch):
    hold_bf16_drift(ref, arch, _cfg(arch), DRIFT)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_steps_over_two_microbatches_match_reference(ref, arch):
    cfg = _cfg(arch, remat=LM["remat"], **_accum(arch))
    assert cfg.train_accum == 2
    params = params_from_jax(unflatten(ref, f"{arch}/lm/params/"), cfg, "cpu",
                             training=True)
    hist = _train(cfg, params, LM["steps"])
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"{arch}/lm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref[f"{arch}/lm/hist/loss"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(hist["loss"]))


def count_step_events(monkeypatch, cfg, batch):
    """One replicated step (stochastic rounding, Philox bits) with every
    quantizer call counted where its plain version runs; returns the count
    and the formula's: 3 x quantized leaves + 2 taps a block a
    microbatch."""
    from repro_torch.kernels import dps_quant as dq
    n = [0]
    quant_call = dq._quant_call

    def counted(*args):
        n[0] += 1
        return quant_call(*args)

    monkeypatch.setattr(dq, "_quant_call", counted)
    mod = registry(cfg.family)
    params = init_params(mod.model_defs(cfg, cfg.master_dtype()), "cpu",
                         torch.Generator().manual_seed(0))
    qcfg = qtrain.QuantConfig()
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg,
                                  accum_steps=cfg.train_accum)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
    step(state, batch)
    pred = QuantPolicy().param_predicate()
    q = sum(pred(p, d) for p, d in tree_lib.leaves_with_path(
        mod.model_defs(cfg)))
    taps = registry(cfg.family).residual_taps(cfg)
    return n[0], 3 * q + 2 * taps * cfg.train_accum


@pytest.mark.parametrize("arch", ARCHS)
def test_step_quantizer_events_follow_the_formula(monkeypatch, arch):
    cfg = _cfg(arch, **_accum(arch))
    assert cfg.remat == "none"
    cfg = dataclasses.replace(cfg, remat="full")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 9),
                                     generator=torch.Generator().manual_seed(1))}
    got, want = count_step_events(monkeypatch, cfg, batch)
    assert got == want


def test_wire_step_launch_counts_rehearse_the_card(monkeypatch):
    """One int8-wire step of mamba2 over 4 stacked ranks, 2 rows a rank in
    the config's 2 microbatches (``chip_smoke.py``'s wire run at smoke
    size), every kernel call counted where its plain version runs: K1b
    3Q + n(2·L·accum + Q) (weights, the optimizer-input snap and the
    re-snap once; each rank's taps in every microbatch, forward and
    backward, and its raw-gradient statistics once), K2b n·G, K4 n, K3b n,
    with Q quantized leaves of G."""
    from repro_torch.dist.transport import StackedTransport
    from repro_torch.kernels import dps_quant as dq
    n = 4
    cfg = _cfg("mamba2_1_3b", remat="full", **_accum("mamba2_1_3b"))
    counts = dict.fromkeys(("K1b", "K2b", "K3b", "K4"), 0)
    quant_call = dq._quant_call
    group_plain, reduce_plain = (dq.dps_quant_group_wire_plain,
                                 dq.dps_wire_reduce_plain)

    def counted_quant_call(x, il, fl, bits, compute_stats, out, backend, wire):
        assert isinstance(bits, dq.Philox)
        counts["K2b" if wire else "K1b"] += 1
        return quant_call(x, il, fl, bits, compute_stats, out, backend, wire)

    def counted_group(*a, **k):
        counts["K3b"] += 1
        return group_plain(*a, **k)

    def counted_reduce(*a, **k):
        counts["K4"] += 1
        return reduce_plain(*a, **k)

    monkeypatch.setattr(dq, "_quant_call", counted_quant_call)
    monkeypatch.setattr(dq, "dps_quant_group_wire_plain", counted_group)
    monkeypatch.setattr(dq, "dps_wire_reduce_plain", counted_reduce)
    defs = mamba.model_defs(cfg, cfg.master_dtype())
    params = init_params(defs, "cpu", torch.Generator().manual_seed(0))
    qcfg = qtrain.QuantConfig(grad_allreduce_bits=8).with_per_layer_wire(
        params)
    opt = make_optimizer(SGDConfig())
    step = qtrain.make_train_step(mamba.loss_fn(cfg), opt, qcfg,
                                  accum_steps=cfg.train_accum,
                                  transport=StackedTransport(n))
    state = qtrain.TrainState.create(params, opt.init(params), qcfg, 3)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=8,
                                         global_batch=2 * n, seed=0))
    _, m = step(state, data.batch(0))
    assert np.isfinite(float(m["loss"]))
    paths = tree_lib.leaves_with_path(defs)
    G = len(paths)
    Q = sum(QuantPolicy().param_predicate()(p, d) for p, d in paths)
    L, accum = cfg.n_layers, cfg.train_accum
    assert counts == {"K1b": 3 * Q + n * (2 * L * accum + Q), "K2b": n * G,
                      "K3b": n, "K4": n}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_smoke_and_serve_refusal(ref, arch):
    out = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--log-every", "1"])
    assert out["params"] == smoke(get_config(arch)).n_params()
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    want = str(ref[f"{arch}/serve/message"])
    assert "has no paged" in want
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "1"])
    assert str(e.value) == want
