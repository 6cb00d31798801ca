"""The serving slice as a whole: repro_torch.serve.Engine against
repro.serve.Engine, and the engine's own equivalences.

Held against the reference, from the same weights and the same seeded
``synthetic_trace``, at ``kv_bits=8`` and ``kv_bits=None``: the generated
tokens of every request identical, ``format_spread`` identical.

Held within the port (as ``tests/test_serve.py`` holds them for the
reference): at ``kv_bits=None`` the paged engine is token-identical to the
contiguous prefill+decode loop; continuous batching is invisible to any
single request; admission is strict FCFS; pool backpressure delays a request
and never drops it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry
from repro_torch.serve import (Engine, EngineConfig, PageAllocator,
                               PagedLayout, Request, Scheduler, page_rows,
                               supports_paging, synthetic_trace)
from test_torch_jaxref import run_reference, unflatten

CFG = smoke(get_config("llama3_2_3b"))
MOD = registry(CFG.family)
LAYOUT = dict(page_size=4, n_pages=24, batch_slots=4, max_pages_per_seq=8,
              max_prompt=16)
LAY = PagedLayout(**LAYOUT)
TRACES = {
    "int8": dict(n=6, prompt_lens=[3, 12], new_tokens=[2, 8], mean_gap=0.5,
                 seed=1, kv_bits=8),
    "fp32": dict(n=6, prompt_lens=[3, 12], new_tokens=[2, 8], mean_gap=0.5,
                 seed=1, kv_bits=None),
    "int8_burst": dict(n=5, prompt_lens=[4, 16], new_tokens=[2, 4],
                       mean_gap=0.0, seed=5, kv_bits=8),
}


@pytest.fixture(scope="module")
def ref():
    return run_reference([{"job": "engine", "tag": "e", "kw": {
        "seed": 0, "layout": LAYOUT, "traces": TRACES}}])


@pytest.fixture(scope="module")
def params(ref):
    return params_from_jax(unflatten(ref, "e/params/"), CFG, "cpu")


def _engine(params, lay=LAY, **kw):
    return Engine(CFG, params, EngineConfig(layout=lay, **kw), device="cpu")


def _trace(tr):
    return synthetic_trace(tr["n"], CFG.vocab,
                           prompt_lens=tuple(tr["prompt_lens"]),
                           new_tokens=tuple(tr["new_tokens"]),
                           mean_gap=tr["mean_gap"], seed=tr["seed"])


@pytest.mark.parametrize("name", sorted(TRACES))
def test_engine_tokens_and_spread_match_reference(ref, params, name):
    tr = TRACES[name]
    reqs = _trace(tr)
    rep = _engine(params, kv_bits=tr["kv_bits"]).run(reqs)
    for r in reqs:
        assert rep.tokens[r.rid] == ref[f"e/{name}/tokens/{r.rid}"].tolist(), r.rid
        assert len(rep.tokens[r.rid]) == r.max_new
    assert rep.format_spread == json.loads(str(ref[f"e/{name}/spread"]))
    assert bool(rep.format_spread) == (tr["kv_bits"] == 8)
    assert rep.metrics["admissions"] == len(reqs)
    assert rep.metrics["total_tokens"] == sum(r.max_new for r in reqs)


def test_paged_fp32_matches_contiguous_decode(params):
    """kv_bits=None: paging is bookkeeping — token-identical to the plain
    contiguous fp32 loop (a full-length prompt keeps the summation orders of
    the two prefill shapes aligned)."""
    prompt = np.random.default_rng(7).integers(1, CFG.vocab, LAY.max_prompt
                                               ).astype(np.int32)
    n_new = 8
    paged = _engine(params, kv_bits=None).run(
        [Request(rid=0, prompt=prompt, max_new=n_new)]).tokens[0]

    logits, cache, pos = MOD.prefill(CFG, params,
                                     torch.from_numpy(prompt)[None],
                                     LAY.max_prompt + n_new)
    toks = [int(logits[0].argmax())]
    for _ in range(n_new - 1):
        lg, cache = MOD.decode_step(CFG, params, torch.tensor([[toks[-1]]]),
                                    cache, pos)
        pos = pos + 1
        toks.append(int(lg[0].argmax()))
    assert paged == toks


def test_continuous_batching_matches_solo_runs(params):
    """Every admitted request decodes to the tokens of a solo run: per-page
    formats are content-pure, trash writes are masked out, and physical page
    ids never enter the math."""
    eng = _engine(params, kv_bits=8)
    reqs = _trace(TRACES["int8"])
    batched = eng.run(reqs)
    for r in reqs:
        solo = eng.run([dataclasses.replace(r, arrival=0)])
        assert solo.tokens[r.rid] == batched.tokens[r.rid], r.rid
    assert all(len(batched.tokens[r.rid]) == r.max_new for r in reqs)
    assert batched.metrics["mean_occupancy"] > 1.0


def test_second_run_repeats_the_first(params):
    eng = _engine(params, kv_bits=8)
    reqs = _trace(TRACES["int8_burst"])
    assert eng.run(reqs).tokens == eng.run(reqs).tokens


def test_int8_close_to_fp32_tokens(params):
    """The int8 page grid is lossy but the first token (pure prefill, no
    cache read) is exactly equal."""
    prompt = np.random.default_rng(9).integers(1, CFG.vocab, 8).astype(np.int32)
    r = Request(rid=0, prompt=prompt, max_new=6)
    t8 = _engine(params, kv_bits=8).run([r]).tokens[0]
    t32 = _engine(params, kv_bits=None).run([r]).tokens[0]
    assert t8[0] == t32[0] and len(t8) == len(t32) == 6


def test_serial_serving_gives_the_same_tokens(params):
    reqs = _trace(TRACES["int8_burst"])
    a = _engine(params, kv_bits=8).run(reqs)
    b = _engine(params, kv_bits=8, max_concurrency=1).run(reqs)
    assert a.tokens == b.tokens
    assert b.metrics["mean_occupancy"] == 1.0


def test_prefill_reads_logits_at_the_prompt_end(params):
    """Prefill runs at the fixed ``max_prompt``; what follows the prompt in
    the padded window must not matter."""
    eng = _engine(params, kv_bits=8)
    toks = np.zeros((1, LAY.max_prompt), np.int32)
    toks[0, :5] = [9, 8, 7, 6, 5]
    a, _, _ = eng.prefill(torch.from_numpy(toks), 5)
    toks[0, 5:] = 77
    b, _, _ = eng.prefill(torch.from_numpy(toks), 5)
    assert torch.equal(a, b) and a.shape == (512,)      # padded vocabulary


def test_scheduler_strict_fcfs():
    reqs = [Request(rid=i, prompt=np.ones(4, np.int32), max_new=2, arrival=a)
            for i, a in enumerate([5, 0, 0])]
    s = Scheduler(reqs)
    assert s.pop_admissible(0, lambda r: True).rid == 1
    # head-of-line blocks even when later requests would fit
    assert s.pop_admissible(0, lambda r: r.rid != 2) is None
    assert s.pop_admissible(0, lambda r: True).rid == 2
    assert s.pop_admissible(0, lambda r: True) is None   # rid 0 not arrived
    assert s.pop_admissible(5, lambda r: True).rid == 0
    s.requeue(reqs[0])
    assert len(s) == 1 and s.next_arrival() == 5


def test_layout_allocator_and_page_rows():
    assert LAY.pages_needed(4, 1) == 1          # last token never written
    assert LAY.pages_needed(4, 2) == 2
    assert LAY.pages_needed(8, 5) == 3
    assert LAY.trash_page == LAY.n_pages and LAY.prompt_pages == 4
    with pytest.raises(ValueError):
        PagedLayout(page_size=4, n_pages=8, batch_slots=1,
                    max_pages_per_seq=4, max_prompt=10)
    a = PageAllocator(6)
    p1 = a.alloc(4)
    assert a.n_free == 2 and len(set(p1)) == 4
    with pytest.raises(RuntimeError):
        a.alloc(3)
    a.release(p1)
    assert a.n_free == 6
    rows = page_rows(3, 10, [7, 2])
    assert rows.shape == (2, 3, 2)
    assert list(rows[0, :, 0]) == [7, 17, 27]
    assert list(rows[1, :, 0]) == [37, 47, 57]


def test_backpressure_never_drops_a_request(params):
    """A pool too small for the whole trace at once: requests wait at the
    queue head for frees, all are served in full, and in FCFS order."""
    small = PagedLayout(page_size=4, n_pages=8, batch_slots=4,
                        max_pages_per_seq=6, max_prompt=16)
    reqs = [Request(rid=i, prompt=np.full(10, i + 1, np.int32), max_new=6,
                    arrival=0) for i in range(5)]       # 4 pages each
    rep = _engine(params, lay=small, kv_bits=8).run(reqs)
    assert all(len(rep.tokens[r.rid]) == r.max_new for r in reqs)
    assert rep.metrics["backpressure_steps"] > 0
    assert rep.metrics["mean_occupancy"] <= 2.0
    roomy = _engine(params, kv_bits=8).run(reqs)
    assert roomy.metrics["backpressure_steps"] == 0
    assert roomy.tokens == rep.tokens


def test_allocator_exhaustion_requeues_instead_of_crashing(params, monkeypatch):
    """The allocator refusing despite the ``can()`` pre-check holds the
    request at the queue head; it is admitted on a later step."""
    real = PageAllocator.alloc
    calls = {"n": 0}

    def flaky(self, n):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected allocator fault")
        return real(self, n)

    monkeypatch.setattr(PageAllocator, "alloc", flaky)
    reqs = _trace(TRACES["int8_burst"])
    rep = _engine(params, kv_bits=8).run(reqs)
    assert all(len(rep.tokens[r.rid]) == r.max_new for r in reqs)
    assert rep.metrics["backpressure_steps"] >= 1
    monkeypatch.undo()
    assert _engine(params, kv_bits=8).run(reqs).tokens == rep.tokens


def test_request_that_can_never_fit_is_refused(params):
    r = Request(rid=0, prompt=np.ones(17, np.int32), max_new=2)
    with pytest.raises(ValueError, match="never fit"):
        _engine(params).run([r])
    with pytest.raises(ValueError):
        Request(rid=1, prompt=np.zeros(0, np.int32), max_new=1)


@pytest.mark.parametrize("what", ["cuda_default", "kernel_on_cpu", "kv_bits",
                                  "backend_name", "family"])
def test_engine_refuses(params, what):
    ecfg = EngineConfig(layout=LAY)
    if what == "cuda_default":
        # entry points default to the card and do not give way to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(CFG, params, ecfg)
    elif what == "kernel_on_cpu":
        with pytest.raises(ValueError, match="CUDA"):
            _engine(params, attn_backend="kernel")
        with pytest.raises(ValueError, match="CUDA"):
            _engine(params, encode_backend="kernel")
    elif what == "kv_bits":
        with pytest.raises(ValueError):
            _engine(params, kv_bits=4)
    elif what == "backend_name":
        with pytest.raises(ValueError):
            _engine(params, attn_backend="jnp")
    else:
        # the VLM trains only (the reference's engine refuses it too); the
        # dense and MoE decoders page
        vlm = dataclasses.replace(CFG, family="vlm")
        assert not supports_paging(vlm) and supports_paging(CFG)
        assert supports_paging(dataclasses.replace(CFG, family="moe"))
        with pytest.raises(ValueError, match="paged"):
            Engine(vlm, params, ecfg, device="cpu")


def test_engine_forces_the_model_cache_off_int8(params):
    """``kv_cache_bits=8`` in the model config must not double-quantize the
    prefill: the engine owns KV quantization at page granularity."""
    cfg8 = dataclasses.replace(CFG, kv_cache_bits=8)
    eng = Engine(cfg8, params, EngineConfig(layout=LAY), device="cpu")
    assert eng.cfg.kv_cache_bits == 16
    reqs = _trace(TRACES["int8_burst"])
    assert eng.run(reqs).tokens == _engine(params).run(reqs).tokens


def test_bf16_model_serves_and_holds_the_fp32_table_once():
    """A bf16 model (the full-size case) keeps fp32 logits: the engine parks
    one fp32 cast of the tied embedding table instead of casting per step,
    and that changes no logit."""
    from repro_torch.models.common import TOK_F32, init_params, unembed
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    gen = torch.Generator(device="cpu").manual_seed(0)
    p16 = init_params(MOD.model_defs(cfg), "cpu", gen)
    assert p16["embed"]["tok"].dtype == torch.bfloat16
    assert p16["layers"]["norm1"].dtype == torch.float32
    eng = Engine(cfg, p16, EngineConfig(layout=LAY), device="cpu")
    assert eng.params["embed"][TOK_F32].dtype == torch.float32
    assert TOK_F32 not in p16["embed"]              # the caller's dict is left alone
    x = torch.randn(2, 1, cfg.d_model).to(torch.bfloat16)
    a = unembed(x, p16["embed"], cfg.vocab)
    b = unembed(x, eng.params["embed"], cfg.vocab)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    reqs = _trace(TRACES["int8_burst"])
    rep = eng.run(reqs)
    assert all(len(rep.tokens[r.rid]) == r.max_new for r in reqs)
    assert rep.tokens == eng.run(reqs).tokens


def test_serve_cli_smoke(capsys):
    rep = serve_cli.main(["--arch", "llama3_2_3b", "--smoke", "--device",
                          "cpu", "--requests", "4", "--slots", "2",
                          "--page-size", "4", "--max-prompt", "8",
                          "--max-new", "6"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "<IL,FL> spread" in out
    assert "attn=plain, encode=plain" in out
    assert rep.metrics["total_tokens"] > 0


def test_serve_cli_fp32_pages_and_default_device(capsys):
    serve_cli.main(["--arch", "llama3_2_3b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--slots", "2", "--kv-bits", "none",
                    "--serial"])
    out = capsys.readouterr().out
    assert "fp32 pages" in out and "serial" in out and "spread" not in out
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--arch", "llama3_2_3b", "--smoke", "--requests", "2"])
