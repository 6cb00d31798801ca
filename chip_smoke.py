#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives ``repro_torch``'s serving path — the path a user reaches through
``python -m repro_torch.launch.serve --arch llama3_2_3b`` — and holds every
CUDA kernel on it against its plain PyTorch version.  Phases, each printing
one JSON line; any failure raises and the process exits non-zero:

1. device  — the card's name, and its power limit as ``nvidia-smi`` gives it.
2. build   — ``nvcc`` builds the kernel library from ``src/repro_torch/
             kernels/csrc`` into ``build/`` and ``ctypes`` loads it.
3. checks  — the grouped wire encoder and paged decode attention against
             their plain versions, at small shapes (odd quanta, stochastic
             rounding, statistics, bf16 input, fp32 pools, empty rows) and at
             the shapes the serving path gives them; then each kernel's
             median time over repeated launches (CUDA events, after warm-up,
             the L2 cache flushed before every launch) beside its plain
             version's and the least time the card could take.
4. serve   — llama3.2-3b at full width and depth (28 layers, d=3072, 24 heads
             / 8 KV heads, Dh=128, d_ff=8192, vocab 128256; bf16 weights
             drawn from seed 0 on the card) behind the continuous-batching
             engine: page size 16, 8 slots, prompts up to 512 tokens, int8
             pages; a seeded trace of 16 requests.  Every request must get
             exactly its ``max_new`` tokens, the launch counters must show
             both kernels on the path, a second run must repeat the first,
             and the engine built on the plain versions must give the same
             prompt pages and first-step logits within ``LOGIT_TOL``.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": <n>}}``.
There is no CPU path here: without a CUDA device the script exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script "
             "runs the CUDA kernels and has no CPU path")

from repro_torch.configs.base import get_config                      # noqa: E402
from repro_torch.kernels import _build, dps_quant, paged_attn        # noqa: E402
from repro_torch.models import registry                              # noqa: E402
from repro_torch.models.common import init_params                    # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, PagedLayout,    # noqa: E402
                               cache as kvc, synthetic_trace)

DEV = torch.device("cuda", 0)

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# fp32 rate outside the tensor cores, which is what both kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

ATTN_TOL = 1e-5      # fp32 attention output; the sums run in another order
SUM_RTOL = 2e-6      # float statistics; thousands of fp32 terms, other order
# First-step logits, kernel engine vs plain engine, bf16 model.  The two
# attention outputs differ by <= 1e-5 in fp32, but each layer casts them to
# bf16 (8 bits of mantissa): a difference that small can still tip a
# rounding by one bf16 step (2^-8 relative), and 28 layers carry it on to
# logits of magnitude ~1.  Measured on an H100: 0.062.
LOGIT_TOL = 0.25

SERVE = dict(page_size=16, slots=8, max_prompt=512, max_new=64,
             requests=16, prompt_lens=(64, 512), new_tokens=(16, 64),
             mean_gap=0.5, seed=0)


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def serve_layout():
    ps = SERVE["page_size"]
    prompt_pages = SERVE["max_prompt"] // ps
    pages_per_seq = prompt_pages + -(-SERVE["max_new"] // ps) + 1
    return PagedLayout(page_size=ps, n_pages=SERVE["slots"] * pages_per_seq,
                       batch_slots=SERVE["slots"],
                       max_pages_per_seq=pages_per_seq,
                       max_prompt=SERVE["max_prompt"])


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush = None


def time_ms(fn, repeats, warmup=3):
    """Median milliseconds of ``fn()`` by CUDA events, one pair per launch,
    the 50 MB L2 cache overwritten before each so the call finds it cold, as
    it does between two layers of the serving path."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(repeats):
        _flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def encode_inputs(rng, tiles, quantum, groups, dtype=torch.float32):
    n = tiles * quantum
    x = rng.standard_normal(n).astype(np.float32) * np.repeat(
        2.0 ** rng.integers(-4, 4, tiles), quantum).astype(np.float32)
    x[::13] = 0.0
    il = rng.integers(1, 6, groups)
    tab = np.stack([il, 8 - il + rng.integers(0, 3, groups)], 1).astype(np.int32)
    tg = np.sort(rng.integers(0, groups, tiles)).astype(np.int32)
    if groups == tiles:
        tg = np.arange(tiles, dtype=np.int32)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)
    mask = (rng.random(n) > 0.15).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(DEV)
    return dict(x=t(x).to(dtype), fmt_tab=t(tab), tile_group=t(tg),
                bits=t(bits), mask=t(mask), quantum=quantum)


def check_encode(inp, *, stochastic, masked, emit_stats):
    """Kernel vs plain on the card: bytes equal; count/nonzero/overflow/max
    exact, float sums to SUM_RTOL.  Returns the largest byte difference and
    the largest relative difference of a float sum."""
    args = (inp["x"], inp["fmt_tab"], inp["tile_group"],
            inp["bits"] if stochastic else None,
            inp["mask"] if masked else None)
    kw = dict(quantum=inp["quantum"], emit_stats=emit_stats)
    wk, sk = dps_quant.dps_quant_group_wire(*args, backend="kernel", **kw)
    wp, sp = dps_quant.dps_quant_group_wire(*args, backend="plain", **kw)
    torch.cuda.synchronize()
    byte_err = int((wk.to(torch.int16) - wp.to(torch.int16)).abs().max())
    if byte_err:
        raise AssertionError(f"grouped wire encode: bytes differ by {byte_err} "
                             f"(quantum {inp['quantum']}, stochastic={stochastic})")
    rel = 0.0
    if emit_stats:
        exact = [0, 1, 2, 6]
        if not torch.equal(sk[:, exact], sp[:, exact]):
            raise AssertionError("grouped wire encode: count/nonzero/overflow/"
                                 "max_abs differ from the plain version")
        sums_k, sums_p = sk[:, 3:6], sp[:, 3:6]
        rel = float(((sums_k - sums_p).abs()
                     / sums_p.abs().clamp(min=1e-30)).max())
        if rel > SUM_RTOL:
            raise AssertionError(f"grouped wire encode: float sums differ by "
                                 f"{rel:.3g} relative (> {SUM_RTOL})")
        # a second launch gives the same bits: no atomics, fixed order
        _, sk2 = dps_quant.dps_quant_group_wire(*args, backend="kernel", **kw)
        if not torch.equal(sk, sk2):
            raise AssertionError("grouped wire encode: statistics changed "
                                 "between two launches")
    elif sk is not None:
        raise AssertionError("emit_stats=False returned statistics")
    return float(byte_err), rel


def attn_inputs(rng, B, P, ps, KV, G, Dh, lens, int8):
    n_pages = B * P + 1
    t = lambda a: torch.from_numpy(a).to(DEV)
    shp = (n_pages, ps, KV, Dh)
    if int8:
        # grid integers of roughly unit-variance K/V, as a normalized
        # transformer produces them: the absolute tolerance is for that scale
        draw = lambda: np.clip(np.rint(rng.standard_normal(shp) * 32.0),
                               -128, 127).astype(np.int8)
        kp, vp = draw(), draw()
        fmt = rng.integers(5, 8, (n_pages, 2)).astype(np.int32)
    else:
        kp = rng.standard_normal(shp).astype(np.float32)
        vp = rng.standard_normal(shp).astype(np.float32)
        fmt = np.zeros((n_pages, 2), np.int32)
    lens = np.asarray(lens, np.int32)
    ptab = rng.permutation(n_pages - 1)[:B * P].reshape(B, P).astype(np.int32)
    for b in range(B):       # entries past a row's last page: the trash page
        ptab[b, -(-int(lens[b]) // ps):] = n_pages - 1
    q = rng.standard_normal((B, KV * G, Dh)).astype(np.float32)
    return dict(q=t(q), k_pages=t(kp), v_pages=t(vp), fmt=t(fmt),
                ptab=t(ptab), lens=t(lens), scale=float(Dh) ** -0.5)


def check_attn(inp):
    args = (inp["q"], inp["k_pages"], inp["v_pages"], inp["fmt"], inp["ptab"],
            inp["lens"])
    ok = paged_attn.paged_decode_attn(*args, scale=inp["scale"], backend="kernel")
    op = paged_attn.paged_decode_attn(*args, scale=inp["scale"], backend="plain")
    torch.cuda.synchronize()
    if ok.shape != op.shape or not bool(torch.isfinite(ok).all()):
        raise AssertionError("paged attention: non-finite or misshapen output")
    err = float((ok - op).abs().max())
    if err > ATTN_TOL:
        raise AssertionError(f"paged attention: max abs err {err:.3g} > {ATTN_TOL}")
    empty = inp["lens"] == 0
    if bool(empty.any()) and bool((ok[empty] != 0).any()):
        raise AssertionError("paged attention: a row of length 0 is not exactly 0")
    return err


def kernel_checks(cfg, lay):
    rng = np.random.default_rng(0)
    small = []
    # --- small shapes: every switch of both kernels ---
    for tiles, quantum, groups, dtype in ((9, 100, 4, torch.float32),
                                          (6, 7, 9, torch.float32),
                                          (11, 1, 2, torch.float32),
                                          (5, 4096, 3, torch.float32),
                                          (7, 1024, 3, torch.bfloat16),
                                          (4, 30, 2, torch.bfloat16)):
        inp = encode_inputs(rng, tiles, quantum, groups, dtype)
        for stochastic in (False, True):
            for masked in (False, True):
                for emit in (False, True):
                    check_encode(inp, stochastic=stochastic, masked=masked,
                                 emit_stats=emit)
        small.append(f"encode T={tiles} q={quantum} G={groups} {dtype}")
    attn_err_small = 0.0
    for B, P, ps, KV, G, Dh, lens, int8 in (
            (4, 4, 4, 2, 2, 16, [1, 7, 16, 0], True),
            (3, 3, 4, 2, 2, 16, [12, 0, 5], False),
            (2, 5, 8, 2, 3, 32, [40, 9], True),
            (2, 2, 4, 4, 1, 8, [8, 3], True),
            (2, 3, 5, 1, 2, 6, [0, 11], False),      # Dh not a multiple of 4
            (2, 2, 4, 1, 2, 8, [0, 0], True)):
        attn_err_small = max(attn_err_small, check_attn(
            attn_inputs(rng, B, P, ps, KV, G, Dh, lens, int8)))
        small.append(f"attn B={B} P={P} ps={ps} KV={KV} G={G} Dh={Dh} int8={int8}")

    # --- the serving path's shapes ---
    L, KV, Dh, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    E = lay.page_size * KV * Dh
    T = 2 * L * lay.prompt_pages
    enc = encode_inputs(rng, T, E, T)
    # as write_prompt_pages calls it: nearest, masked, no statistics
    enc_err, _ = check_encode(enc, stochastic=False, masked=True, emit_stats=False)
    # and with everything on, at the same size
    _, enc_rel = check_encode(enc, stochastic=True, masked=True, emit_stats=True)
    n = T * E
    enc_bytes = 4 * n + 4 * n + n + 4 * T + 8 * T     # x, mask, wire, map, table
    enc_ops = 12 * n                                   # scale, 3 clips, round, mask...
    enc_args = (enc["x"], enc["fmt_tab"], enc["tile_group"], None, enc["mask"])
    enc_kw = dict(quantum=E, emit_stats=False)
    enc_ms = time_ms(lambda: dps_quant.dps_quant_group_wire(
        *enc_args, backend="kernel", **enc_kw), repeats=20)
    enc_plain_ms = time_ms(lambda: dps_quant.dps_quant_group_wire(
        *enc_args, backend="plain", **enc_kw), repeats=5, warmup=1)

    B, P = lay.batch_slots, lay.max_pages_per_seq
    # decode lengths as the trace produces them: prompts of 64-512 tokens
    # plus up to 64 generated, one idle slot
    lens = [577, 512, 300, 129, 64, 65, 1, 0]
    att = attn_inputs(rng, B, P, lay.page_size, KV, H // KV, Dh, lens, True)
    att_err = check_attn(att)
    att32 = attn_inputs(rng, B, P, lay.page_size, KV, H // KV, Dh, lens, False)
    att_err = max(att_err, check_attn(att32))
    tokens = sum(lens)
    att_bytes = (2 * tokens * KV * Dh            # int8 K and V of valid tokens
                 + 2 * 4 * B * H * Dh            # q in, out
                 + 4 * B * P + 4 * B             # page table, lengths
                 + 8 * sum(-(-t // lay.page_size) for t in lens))   # FL rows
    att_ops = 4 * tokens * H * Dh                # q·k and p·v, multiply + add
    att_args = (att["q"], att["k_pages"], att["v_pages"], att["fmt"],
                att["ptab"], att["lens"])
    att_ms = time_ms(lambda: paged_attn.paged_decode_attn(
        *att_args, scale=att["scale"], backend="kernel"), repeats=50)
    att_plain_ms = time_ms(lambda: paged_attn.paged_decode_attn(
        *att_args, scale=att["scale"], backend="plain"), repeats=5, warmup=1)

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_OPS_PER_S * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    enc_bound, enc_by = bound(enc_bytes, enc_ops)
    att_bound, att_by = bound(att_bytes, att_ops)
    rows = [
        {"name": "dps_group_wire_encode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
         "replaces": "src/repro/kernels/dps_quant.py:482",
         "shape": f"T={T} tiles x quantum={E} fp32, nearest, masked, no stats",
         "max_abs_err": enc_err, "stats_max_rel_err": enc_rel,
         "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
         "bound_by": enc_by, "bytes": enc_bytes, "library_ms": None},
        {"name": "paged_decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:157",
         "shape": f"B={B} H={H} KV={KV} Dh={Dh} page={lay.page_size} P={P} "
                  f"int8, lens={lens}",
         "max_abs_err": att_err, "ms": att_ms, "plain_ms": att_plain_ms,
         "bound_ms": att_bound, "bound_by": att_by, "bytes": att_bytes,
         "library_ms": None},
    ]
    say("checks", small_shapes=small, attn_max_abs_err_small=attn_err_small,
        tolerances={"encode_bytes": 0, "encode_float_sums_rel": SUM_RTOL,
                    "attn_abs": ATTN_TOL},
        main_path=[{k: r[k] for k in ("name", "shape", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows])
    return rows


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def compare_with_plain(cfg, params, lay, req):
    """Kernel engine vs plain engine on the card, one request: prompt pages
    byte-equal, controller rows equal, first decode step's logits close."""
    out = {}
    for name in ("kernel", "plain"):
        eng = Engine(cfg, params, EngineConfig(
            layout=lay, kv_bits=8, attn_backend=name, encode_backend=name),
            device=DEV)
        pools = kvc.init_pool(cfg, lay, 8, DEV)
        state = eng.plan.init(DEV)[kvc.KV_DOMAIN]
        plen = int(req.prompt.size)
        need = lay.pages_needed(plen, req.max_new)
        pages = list(range(need))
        toks = np.zeros(lay.max_prompt, np.int32)
        toks[:plen] = req.prompt
        logits, ck, cv = eng.prefill(torch.from_numpy(toks).to(DEV)[None], plen)
        phys = np.full(lay.prompt_pages, lay.trash_page, np.int32)
        npp = min(need, lay.prompt_pages)
        phys[:npp] = pages[:npp]
        pools, state = eng.encode(pools, state, ck, cv,
                                  torch.from_numpy(phys).to(DEV), plen)
        live = -(-plen // lay.page_size)
        prompt_k = pools.k_pages[:, :live].clone()
        prompt_v = pools.v_pages[:, :live].clone()
        ptab = np.full((lay.batch_slots, lay.max_pages_per_seq),
                       lay.trash_page, np.int32)
        ptab[0, :need] = pages
        pos = np.zeros(lay.batch_slots, np.int32)
        pos[0] = plen
        last = np.zeros((lay.batch_slots, 1), np.int32)
        last[0, 0] = int(logits.argmax())
        step_logits, _ = eng.decode(torch.from_numpy(last).to(DEV), pools, state,
                                    torch.from_numpy(ptab).to(DEV),
                                    torch.from_numpy(pos).to(DEV))
        out[name] = (prompt_k, prompt_v, state, step_logits[0, :cfg.vocab].clone())
    (kk, kv_, ks, kl), (pk, pv, ps_, pl) = out["kernel"], out["plain"]
    if not (torch.equal(kk, pk) and torch.equal(kv_, pv)):
        raise AssertionError("prompt pages differ between the kernel and the "
                             "plain page encoder")
    if not (torch.equal(ks.il, ps_.il) and torch.equal(ks.fl, ps_.fl)):
        raise AssertionError("page formats differ between the two engines")
    if not bool(kk.ne(0).any()):
        raise AssertionError("prompt pages are all zero")
    err = float((kl - pl).abs().max())
    if not bool(torch.isfinite(kl).all()) or err > LOGIT_TOL:
        raise AssertionError(f"first decode step: logits differ by {err:.3g} "
                             f"(> {LOGIT_TOL}) between kernel and plain")
    return err, float(pl.abs().max()), int(kl.argmax()) == int(pl.argmax())


def serve(cfg, lay):
    mod = registry(cfg.family)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SERVE["seed"])
    params = init_params(mod.model_defs(cfg), DEV, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, EngineConfig(layout=lay, kv_bits=8), device=DEV)
    if (eng._attn_backend, eng._enc_backend) != ("kernel", "kernel"):
        raise AssertionError("backends 'auto' did not resolve to the kernels")
    reqs = synthetic_trace(SERVE["requests"], cfg.vocab,
                           prompt_lens=SERVE["prompt_lens"],
                           new_tokens=SERVE["new_tokens"],
                           mean_gap=SERVE["mean_gap"], seed=SERVE["seed"] + 1)

    eng.run(reqs[:2])                       # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the counted run: counts to 0 just before, read just after
    dps_quant.launch_count = 0
    paged_attn.launch_count = 0
    rep = eng.run(reqs)
    launches = {"dps_group_wire_encode": dps_quant.launch_count,
                "paged_decode_attn": paged_attn.launch_count}
    peak = torch.cuda.max_memory_allocated()

    m = rep.metrics
    steps = int(m["decode_steps"])
    for r in reqs:
        got = rep.tokens[r.rid]
        if len(got) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(got)} tokens, wanted "
                                 f"{r.max_new}")
        if not all(0 <= t < cfg.vocab for t in got):
            raise AssertionError(f"request {r.rid}: token outside the vocabulary")
    if launches["paged_decode_attn"] != cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attn']} times, wanted "
                             f"{cfg.n_layers} x {steps} decode steps")
    if launches["dps_group_wire_encode"] != len(reqs):
        raise AssertionError(f"page encoder launched "
                             f"{launches['dps_group_wire_encode']} times, "
                             f"wanted one per admission ({len(reqs)})")
    if sum(rep.format_spread.values()) == 0:
        raise AssertionError("no prompt page was placed on a grid")

    rep2 = eng.run(reqs)
    if rep2.tokens != rep.tokens:
        raise AssertionError("a second run of the same trace gave other tokens")

    logit_err, logit_max, same_argmax = compare_with_plain(cfg, params, lay,
                                                           reqs[0])

    say("serve", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params=cfg.n_params(), weights_init_s=init_s,
        requests=len(reqs), total_tokens=int(m["total_tokens"]),
        wall_s=m["wall_s"], tokens_per_s=m["tokens_per_s"], decode_steps=steps,
        mean_occupancy=m["mean_occupancy"],
        p50_ms_per_decode_step=m["p50_ms_per_step"],
        p95_ms_per_decode_step=m["p95_ms_per_step"],
        prefill_and_encode_s_total=m["prefill_s_total"],
        peak_memory_bytes=peak, launches=launches,
        format_spread=rep.format_spread, second_run_same_tokens=True,
        plain_engine={"prompt_pages_equal": True,
                      "first_step_logits_max_abs_err": logit_err,
                      "first_step_logits_max_abs": logit_max,
                      "tolerance": LOGIT_TOL, "same_argmax": same_argmax})
    return launches


def main():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    say("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.load(verbose=True)
    say("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=_build.build_seconds,
        sources=[os.path.relpath(p, ROOT) for p in _build.sources()],
        library=os.path.relpath(_build.build(), ROOT))

    cfg = get_config("llama3_2_3b")
    lay = serve_layout()
    rows = kernel_checks(cfg, lay)
    launches = serve(cfg, lay)
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on the main path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
