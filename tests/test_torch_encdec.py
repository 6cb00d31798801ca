"""The encoder-decoder family (whisper-medium) in the port against the JAX
package's, from the same weights.  Held, in fp32 at smoke size, within
``TOL``:

* every field of the config and its full-size parameter count equal to the
  reference's;
* ``gqa_apply``'s two paths the family needs, at ``S_k ≠ S_q``:
  cross-attention by ``kv_x`` (train and prefill mode; the prefill's cross
  K/V at ``kv_cache_bits`` 16 and 8) and ``decode_static`` over a fixed
  fp32 and int8 cache;
* prefill logits and caches (the self and the cross K/V; stubbed frames
  from a numpy seed), and 3 decode steps from the reference's prefill
  cache, their logits and the caches after them, at ``kv_cache_bits`` 16
  and 8 (the int8 caches bit-equal); the port's decode after its own
  prefill equals its prefill of one more token;
* the same at the bf16 working dtype from the reference's bf16 weights
  (``test_torch_ssm.hold_bf16_drift``);
* 3 SGD steps under nearest rounding with the frames on every batch:
  ⟨IL, FL⟩ of every domain identical at every step, the loss to
  ``LOSS_RTOL``;
* a step's quantizer events (3 per quantized leaf, a tap per encoder and
  decoder block forward and backward); the training CLI (zero frames) on
  the CPU; the serving CLI refuses the family with the reference's
  message.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, encdec, registry
from test_torch_jaxref import run_reference, unflatten
from test_torch_ssm import (DRIFT, DRIFT_SEQ, FMTS, LM, LOSS_RTOL, MAX_SEQ,
                            TOL, _cache_flat, _close, _t, _train,
                            check_decode, check_prefill, count_step_events,
                            hold_bf16_drift)

ARCH = "whisper_medium"
FULL_PARAMS = 758_297_600

_rng = np.random.default_rng(23)
_C = smoke(get_config(ARCH))


def _f32(*shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_arrays():
    D, H, KV, Dh = _C.d_model, _C.n_heads, _C.n_kv_heads, _C.head_dim
    a = {f"p/{k}": _f32(*s, scale=0.25) for k, s in (
        ("wq", (D, H * Dh)), ("wk", (D, KV * Dh)), ("wv", (D, KV * Dh)),
        ("wo", (H * Dh, D)), ("bq", (H * Dh,)), ("bk", (KV * Dh,)),
        ("bv", (KV * Dh,)), ("bo", (D,)))}
    B, Sq, Sk = 2, 5, 7
    a.update(x=_f32(B, Sq, D), kv_x=_f32(B, Sk, D), x1=_f32(B, 1, D),
             ck=_f32(B, Sk, KV, Dh), cv=_f32(B, Sk, KV, Dh),
             ck8=_rng.integers(-128, 128, (B, Sk, KV, Dh)).astype(np.int8),
             cv8=_rng.integers(-128, 128, (B, Sk, KV, Dh)).astype(np.int8))
    return a


ATTN = _attn_arrays()
MODEL = {"tokens": _rng.integers(1, 256, (2, 8)).astype(np.int32),
         "steps": _rng.integers(1, 256, (2, 3)).astype(np.int32),
         "frames": _f32(2, _C.enc_seq, _C.d_model)}
LM_FRAMES = _f32(LM["batch"], _C.enc_seq, _C.d_model)
DRIFT_FRAMES = _f32(2, _C.enc_seq, _C.d_model)


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "config", "tag": "cfg", "kw": {"archs": [ARCH]}},
            {"job": "cross_attn", "tag": "attn", "kw": {}},
            {"job": "decode_model", "tag": f"{ARCH}/model", "kw": dict(
                seed=0, arch=ARCH, max_seq=MAX_SEQ, bits=[16, 8])},
            {"job": "lm_train", "tag": "lm", "kw": dict(LM, arch=ARCH)},
            {"job": "serve_refusal", "tag": "serve", "kw": {"arch": ARCH}},
            {"job": "bf16_drift", "tag": f"{ARCH}/drift", "kw": dict(
                seed=1, arch=ARCH, max_seq=DRIFT_SEQ)}]
    arrays = {f"attn/{k}": v for k, v in ATTN.items()}
    arrays.update({f"{ARCH}/model/{k}": v for k, v in MODEL.items()})
    arrays.update({f"{ARCH}/drift/{k}": v for k, v in DRIFT.items()})
    arrays[f"{ARCH}/drift/frames"] = DRIFT_FRAMES
    arrays["lm/frames"] = LM_FRAMES
    return run_reference(jobs, arrays)


def test_config_fields_and_full_size_count_match_reference(ref):
    cfg = get_config(ARCH)
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == json.loads(
        str(ref[f"cfg/{ARCH}/fields"]))
    assert cfg.n_params() == float(ref[f"cfg/{ARCH}/n_params"]) == FULL_PARAMS
    assert registry(cfg.family) is encdec
    s = smoke(cfg)
    assert (s.n_enc_layers, s.enc_seq) == (2, 16)


def _attn_params():
    return {k[2:]: _t(v) for k, v in ATTN.items() if k.startswith("p/")}


@pytest.mark.parametrize("bits", [16, 8])
def test_cross_attention_matches_reference(ref, bits):
    cfg = dataclasses.replace(_C, kv_cache_bits=bits)
    p, x, kv_x = _attn_params(), _t(ATTN["x"]), _t(ATTN["kv_x"])
    assert x.shape[1] != kv_x.shape[1]
    positions = torch.arange(x.shape[1], dtype=torch.int32)[None]
    out, cache = attention.gqa_apply(cfg, p, x, positions=positions,
                                     mode="train", kv_x=kv_x, causal=False)
    assert cache is None
    _close(out, ref[f"attn/{bits}/train"], "train")
    out, (ck, cv) = attention.gqa_apply(cfg, p, x, positions=positions,
                                        mode="prefill", kv_x=kv_x,
                                        causal=False)
    _close(out, ref[f"attn/{bits}/prefill"], "prefill")
    assert ck.shape == (2, kv_x.shape[1], cfg.n_kv_heads, cfg.head_dim)
    if bits == 8:
        # the same quantization of the same projection: bit-equal
        assert ck.dtype == cv.dtype == torch.int8
        np.testing.assert_array_equal(ck.numpy(), ref["attn/8/ck"])
        np.testing.assert_array_equal(cv.numpy(), ref["attn/8/cv"])
    else:
        _close(ck, ref["attn/16/ck"], "ck")
        _close(cv, ref["attn/16/cv"], "cv")


@pytest.mark.parametrize("bits", [16, 8])
def test_decode_static_matches_reference(ref, bits):
    name = "static8" if bits == 8 else "static"
    sfx = "8" if bits == 8 else ""
    cache = (_t(ATTN["ck" + sfx]), _t(ATTN["cv" + sfx]))
    at = torch.full((2, 1), 5, dtype=torch.int32)
    before = [c.clone() for c in cache]
    out, new = attention.gqa_apply(_C, _attn_params(), _t(ATTN["x1"]),
                                   positions=at, mode="decode_static",
                                   cache=cache)
    assert new is None
    assert all(torch.equal(a, b) for a, b in zip(cache, before))  # no write
    _close(out, ref[f"attn/{name}"], name)


@pytest.mark.parametrize("bits", [16, 8])
def test_prefill_matches_reference(ref, bits):
    cfg = dataclasses.replace(_C, kv_cache_bits=bits)
    params = params_from_jax(unflatten(ref, f"{ARCH}/model/params/"), cfg,
                             "cpu")
    cache = check_prefill(ref, ARCH, cfg, params, _t(MODEL["tokens"]),
                          {"frames": _t(MODEL["frames"])})
    if bits == 8:
        _int8_bit_equal(cache, ref, "prefill_cache")


def _int8_bit_equal(cache, ref, which):
    """whisper's int8 caches take no value near a rounding boundary at
    this seed: bit-equal to the reference's."""
    for key, v in _cache_flat(cache).items():
        assert v.dtype == torch.int8
        np.testing.assert_array_equal(
            v.to(torch.float32).numpy(), ref[f"{ARCH}/model/8/{which}/{key}"],
            err_msg=key)


@pytest.mark.parametrize("bits", [16, 8])
def test_decode_steps_match_reference(ref, bits):
    cfg = dataclasses.replace(_C, kv_cache_bits=bits)
    params = params_from_jax(unflatten(ref, f"{ARCH}/model/params/"), cfg,
                             "cpu")
    pos = torch.full((2,), MODEL["tokens"].shape[1], dtype=torch.int32)
    cache = check_decode(ref, ARCH, cfg, params, _t(MODEL["steps"]), pos)
    if bits == 8:
        _int8_bit_equal(cache, ref, "decode_cache")


def test_decode_after_prefill_equals_the_longer_forward(ref):
    params = params_from_jax(unflatten(ref, f"{ARCH}/model/params/"), _C,
                             "cpu")
    frames = _t(MODEL["frames"])
    tokens = _t(np.concatenate([MODEL["tokens"], MODEL["steps"][:, :1]], 1))
    _, cache, pos = encdec.prefill(_C, params, tokens[:, :-1], MAX_SEQ,
                                   frames=frames)
    lg, _ = encdec.decode_step(_C, params, tokens[:, -1:], cache, pos)
    full, _, _ = encdec.prefill(_C, params, tokens, MAX_SEQ, frames=frames)
    assert float((lg - full).abs().max()) <= TOL


def test_bf16_drift_matches_reference(ref):
    hold_bf16_drift(ref, ARCH, _C, DRIFT, {"frames": _t(DRIFT_FRAMES)})


def test_lm_steps_with_frames_match_reference(ref):
    cfg = dataclasses.replace(_C, remat=LM["remat"])
    params = params_from_jax(unflatten(ref, "lm/params/"), cfg, "cpu",
                             training=True)
    hist = _train(cfg, params, LM["steps"], {"frames": _t(LM_FRAMES)})
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"lm/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref["lm/hist/loss"],
                               rtol=LOSS_RTOL)


def test_step_quantizer_events_follow_the_formula(monkeypatch):
    cfg = dataclasses.replace(_C, remat="full")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=g),
             "frames": torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g)}
    got, want = count_step_events(monkeypatch, cfg, batch)
    assert got == want


def test_train_cli_smoke_and_serve_refusal(ref):
    out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--log-every", "1"])
    assert out["params"] == _C.n_params()
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    want = str(ref["serve/message"])
    assert want.startswith("whisper-medium: family 'encdec' has no paged")
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "1"])
    assert str(e.value) == want
