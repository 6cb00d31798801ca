#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives ``repro_torch``'s paths — serving (``python -m
repro_torch.launch.serve``), quantized training (``python -m
repro_torch.launch.train``, and the paper's LeNet app), data-parallel
training over the int8 wire (``launch.train --grad-allreduce-bits 8
--data-ranks 4``, with ZeRO-1 and the overlapped bucketed wire:
``--zero-opt --wire-overlap on``), and that trainer's checkpoint, resume,
health guards and fault drills (``--ckpt-dir``, ``--resume``,
``--sigterm-at``, ``--guards``, ``--inject-nan-at``, ``--rollback-ring``)
— and holds every CUDA kernel on them
against its plain PyTorch version.  Phases, each printing one
JSON line; any failure raises and the process exits non-zero:

1. device  — the card's name, and its power limit as ``nvidia-smi`` gives it.
2. build   — ``nvcc`` builds the kernel library from ``src/repro_torch/
             kernels/csrc`` into ``build/`` and ``ctypes`` loads it.
3. checks  — the grouped wire encoder (K3) and paged decode attention (K5)
             against their plain versions, at small shapes (odd quanta,
             stochastic rounding, statistics, bf16 input, fp32 pools, empty
             rows; for K5's splits rows of exactly P·ps tokens, lengths at a
             split boundary and one either side, more than 132 split blocks)
             and at the shapes the serving path gives them, K5 also at a long
             context (8 rows of 4,096 tokens), int8 and fp32 pools, to
             ``ATTN_TOL``, rows of length 0 exactly 0, two launches
             bit-equal; then each kernel's median time over repeated
             launches (CUDA events, after warm-up, the L2 cache flushed
             before every launch; K5 replayed from a CUDA graph, so that its
             tens of microseconds are not timed behind the Python wrapper)
             beside its plain version's and the least time the card could
             take, K5 at both shapes.
4. quantize — the training quantizer, K1 (bits operand) and K1b (Philox bits
             made in the kernel), the same way: small shapes (fp32 and bf16,
             ragged tails, aligned and unaligned, nearest and stochastic,
             statistics on and off) and the shapes the training paths give
             them: K1b the stacked ``w_in`` leaf (704,643,072 fp32 values, one
             launch) and a residual tap (2x512x3072 bf16); K1 one layer of
             ``w_in`` (3072x8192 fp32: with a bits operand the leaf is
             quantized layer by layer) and LeNet's ``fc1_w`` and first tap.
             K1's row is timed at the layer, K1b's at the leaf.  q bit-equal
             to the plain version; count,
             nonzero, overflow and max_abs exact; float sums to ``SUM_RTOL``;
             K1b bit-equal to K1 fed the plain Philox stream; two launches
             equal; the mean of K1b over 64 seeds unbiased to 4 sigma.
5. serve   — llama3.2-3b at full width and depth (28 layers, d=3072, 24 heads
             / 8 KV heads, Dh=128, d_ff=8192, vocab 128256; bf16 weights
             drawn from seed 0 on the card) behind the continuous-batching
             engine: page size 16, 8 slots, prompts up to 512 tokens, int8
             pages; a seeded trace of 16 requests.  Every request must get
             exactly its ``max_new`` tokens, the launch counters must show
             both kernels on the path, a second run must repeat the first,
             and the engine built on the plain versions must give the same
             prompt pages and first-step logits within ``LOGIT_TOL``.
6. lenet   — the paper's app: 20 steps of ``train_mnist`` under the paper's
             controller with stochastic rounding from a bits operand (K1 on
             every quantization event); then 3 steps under nearest and 3
             under stochastic rounding (the same operand bits on both sides)
             with the kernel and with the plain quantizer: <IL, FL> equal
             step by step, loss to ``LENET_LOSS_RTOL``.
7. train   — ``repro_torch.launch.train --arch llama3_2_3b --steps 4 --batch 2
             --seq 512 --optimizer sgd`` at full width and depth (fp32 master
             weights, bf16 compute, full remat), every quantization event on
             K1b: finite losses, <IL, FL> chosen on the device, 80 quantizer
             launches a step.  Then 3 steps with ``--rounding-bits operand``,
             every event on K1: 647 launches a step.
8. wire    — the int8 wire of data-parallel training.  The wire quantizer
             K2/K2b (sizes, bf16, unaligned pointers and Philox offsets,
             saturating formats, statistics on and off, a slot of a larger
             buffer, NaN), the fused decode-reduce K4 (1-300 ranks, several
             formats, ragged chunks, strided rows; for its TMA body a chunk
             shorter than a span, quanta below and above the span, a ragged
             last tile, rows at the int8 extremes; a 16-byte row stride from
             a base off 16 bytes on the grid-stride body; each launch on the
             body ``reduce_plan`` gives, by the TMA counter) and the grouped
             encoder's
             Philox source K3b (every owner's chunk of several layouts)
             against their plain versions, wire bytes and means bit-equal;
             K3's counts exact on a group of 16,781,312 elements.  At the
             path's shapes: K2 (bits operand, and nearest) and K2b on the
             w_in gradient leaf, K4 on one owner's [4, c] strided view of the
             full tree's layout (on the TMA body; ``torch.sum`` of the same
             int8 rows into fp32 timed beside it, the same bytes but not the
             same function), K3b and K3 with a bits operand on that
             owner's chunk, each timed beside its plain version and bound.
             Then ``dps_allreduce_mean_tree`` on a ragged tree over 4 ranks
             (scalar and per-leaf formats, nearest rounding, and stochastic
             with Philox and with a bits operand), kernels vs plain versions:
             means bit-equal; ``ProcessGroupTransport`` over NCCL with one
             rank equals ``StackedTransport(1)``.  Then ``repro_torch.launch.
             train --arch llama3_2_3b --steps 4 --batch 4 --seq 512
             --optimizer sgd --grad-allreduce-bits 8 --data-ranks 4``: 4
             data-parallel ranks on the card at full width, finite losses,
             the wire formats chosen on the device, and per step 4 x 11 K2b
             launches, 4 K4 (every one on the TMA body), 4 K3b and 280 K1b,
             as the CPU rehearsal of the step counts them.  Last, the same
             for 2 steps with
             ``--rounding-bits operand``: per step 4 x 11 K2, 4 K4, 4 K3 and
             1,603 K1 (stacked leaves one layer at a time).
9. zero    — ZeRO-1 and the overlapped bucketed wire.  On the ragged tree
             over 4 ranks (scalar and per-leaf formats; nearest, Philox and
             a bits operand), kernels vs plain versions: the bucketed
             all-reduce (bit-equal to the monolithic one too), the ZeRO
             reduce-scatter over one bucket and over a bucket a leaf (each
             owner's shard bit-equal to its chunk of the all-reduce's mean),
             the ZeRO params all-gather (K3/K3b with statistics and each
             owner's chunk of the mask), ``dps_reduce_scatter_mean`` and
             ``dps_allgather_params``; results bit-equal, statistics exact and
             to ``SUM_RTOL``.  At full width, the overlap run's largest
             bucket (the w_in leaf's, keyed by global leaf 7): 4 ranks
             encoded into it, then ``TreeAllReduce(layout=...)``'s K4 and
             leg-2 K3b on every owner's [4, 176,160,768] and the local
             decode, kernels vs plain, bytes and shards bit-equal; K4 and
             K3b timed there (and ``torch.sum`` beside K4).  K4 at every one
             of the overlap run's 11 buckets (owner 1's view, the bucket's
             tiles and formats): bit-equal on the TMA body, timed from a CUDA
             graph beside its bound, the sum x 4 owners printed as K4 a
             step.  LeNet over 4 ranks with ``zero_opt_shards=4``
             (every leaf quantized, so the params all-gather is int8): 3 steps
             kernel vs plain under nearest rounding, formats equal, loss to
             ``LENET_LOSS_RTOL``, per step 88 K1, 32 K2, 4 K4, 8 K3.  Then
             ``launch.train ... --data-ranks 4 --zero-opt`` and ``--zero-opt
             --wire-overlap on`` at full width, 4 steps each: ZeRO (and the
             overlap, 11 buckets) engaged, the first loss bit-equal to the
             wire run's and the later ones to ``ZERO_LOSS_RTOL``, per step
             4 x 11 K2b, 272 K1b and 4 K4 and 4 K3b (4 x 11 of each with the
             overlap), as the CPU rehearsal counts them, every K4 on the TMA
             body; every metric of
             every step of the overlap run bit-equal to the run without it.
Phases 10-14 run right after phase 8's counted wire run, before its
``--rounding-bits operand`` run.
10. ckpt_resume — checkpoint and resume at full width: the counted wire
             run of phase 8 (run A) also writes its step-4 checkpoint
             (``--ckpt-dir``, the reference's format: 25.7 GB of fp32
             parameters and momenta) under a fresh directory in ``build/``,
             after a check that the disk there holds two such states; run B
             takes ``--sigterm-at 2`` (a real SIGTERM: ``PREEMPTED``, a
             checkpoint at step 2, a clean return), run B′ ``--resume``s to
             step 4.  Held with no tolerance: B's steps 0-1 and B′'s steps
             2-3 equal A's in every metric, and B′'s step-4 manifest digests
             equal A's for every array (the whole state).  Printed: the free
             space, bytes on disk, and seconds and GB/s of each save's
             device → host copy (the stall the step loop sees) and background
             write plus hash, of ``verify_step`` and of ``restore``.
11. ckpt_corrupt — smoke size on the card: a bit flip and a truncation of
             the newest checkpoint are walked past by ``latest_step``,
             refused by ``restore``, and ``--resume`` lands on the good step;
             a ``--zero-opt`` run preempted and resumed equals its
             uninterrupted run (every metric, every digest).
12. guards_idle — the full-width wire run with ``--guards`` and no fault:
             every metric of run A bit-equal, health 0; its ms a step and
             peak memory beside A's.
13. guards_nan — the same with ``--inject-nan-at 1 --guard-cooldown 1``:
             step 1 flags its NaN gradients, degrades and is skipped, the
             parameters, momenta and DPS state held exactly (device
             fingerprints: the int64 sum and the max of each leaf's 32-bit
             patterns, but for the trip's +1 IL on the compute gradients);
             step 2 runs the fp32 fallback with no K2b, K4 or K3b launch and
             the rest as run A; step 3 is back on int8 with A's launches.
14. rollback — smoke size on the card, the reference test's drill
             (``--inject-nan-at 5 --rollback-ring 2``, no guards): 1-8
             rollbacks, a finite replayed loss after each, the run completes.

The line before the last two carries the kernels (launches on their path —
K1's from the LM run with a bits operand, LeNet's beside them; K2b's, K3b's
and K4's from the wire run; K2's from the wire run with a bits operand; K5's
from the serving run, on its serving-shape row, and 0 on the row that times
the same kernel at 8 x 4,096 tokens, a shape no path here runs (that row says
``"on_path": false``); a row launched by the zero phase adds
``launches_lenet_zero`` and ``launches_zero`` (and ``launches_zero_overlap``
where the overlap launches it at the row's shape); K4 and K3b have a second
row each at the overlap's w_in bucket, whose launches are every per-bucket
launch of the overlap run (``"run"`` and ``"counter"`` name them), and
K4's rows add ``body``, ``torch_sum_ms`` and, at the bucket, every bucket's
time and K4 a step —
error against the plain
version, time, plain time, bound; K2b's row adds its time at nearest
rounding without statistics, the bare pipe); the line before
the last is ``nvidia-smi``'s name and power limit; the last line of standard
output is ``{"ok": true, "device": {"platform": "gpu", "kind": <name>,
"count": <n>}}``.  There is no CPU path here: without a CUDA device the
script exits non-zero.
"""

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script "
             "runs the CUDA kernels and has no CPU path")

from kernel_ab import time_graph_ms, time_ms                         # noqa: E402
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
# LeNet under nearest rounding, kernel quantizer vs plain: the grid values are
# bit-equal, so the two runs differ only where the statistics' float sums
# (another summation order) could move a controller decision; they do not.
LENET_LOSS_RTOL = 1e-5

TORCH_SUM_NOTE = ("torch.sum(view, dim=0, dtype=torch.float32): same "
                  "bytes, not the same function; the port never calls it")

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

def bound(nbytes, ops):
    """The least time the card could take: bytes over its memory rate or
    fp32 operations over its fp32 rate, whichever is larger."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


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
    again = paged_attn.paged_decode_attn(*args, scale=inp["scale"], backend="kernel")
    if not torch.equal(ok, again):
        raise AssertionError("paged attention: two launches gave different bits")
    return err


def attn_bytes_ops(B, H, KV, Dh, ps, P, lens):
    """Bytes K5 must move (int8 K and V of the valid tokens, q in, out, the
    page table, the lengths, the live pages' FL rows) and its fp32
    operations (q·k and p·v, a multiply and an add each)."""
    tokens = sum(lens)
    nbytes = (2 * tokens * KV * Dh + 2 * 4 * B * H * Dh + 4 * B * P + 4 * B
              + 8 * sum(-(-t // ps) for t in lens))
    return nbytes, 4 * tokens * H * Dh


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
            (2, 2, 4, 1, 2, 8, [0, 0], True),
            # split edges (a split is 128 tokens of 16-token pages, 48 in an
            # fp32 pool): rows of exactly P·ps tokens, lengths at a split
            # boundary and one either side, more than 132 split blocks
            (4, 24, 16, 8, 3, 128, [384, 128, 127, 129], True),
            (4, 24, 16, 8, 3, 128, [384, 48, 47, 49], False),
            (3, 16, 16, 2, 3, 128, [256, 255, 129], True),
            (5, 40, 16, 8, 3, 128, [640, 639, 1, 0, 385], True),
            (2, 9, 5, 2, 5, 20, [45, 26], False),
            (3, 30, 4, 2, 4, 64, [120, 128, 64], True)):
        attn_err_small = max(attn_err_small, check_attn(
            attn_inputs(rng, B, P, ps, KV, G, Dh, lens, int8)))
        small.append(f"attn B={B} P={P} ps={ps} KV={KV} G={G} Dh={Dh} int8={int8} "
                     f"lens={lens}")

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
    G = H // KV
    # decode lengths as the trace produces them: prompts of 64-512 tokens
    # plus up to 64 generated, one idle slot
    lens = [577, 512, 300, 129, 64, 65, 1, 0]
    att = attn_inputs(rng, B, P, lay.page_size, KV, G, Dh, lens, True)
    att_err = check_attn(att)
    att32 = attn_inputs(rng, B, P, lay.page_size, KV, G, Dh, lens, False)
    att_err = max(att_err, check_attn(att32))
    del att32
    # a long context: 8 rows of 4,096 tokens (67.1 MB of int8 K and V)
    lp, long_lens = 4096 // lay.page_size, [4096] * B
    lng = attn_inputs(rng, B, lp, lay.page_size, KV, G, Dh, long_lens, True)
    lng_err = check_attn(lng)
    lng32 = attn_inputs(rng, B, lp, lay.page_size, KV, G, Dh, long_lens, False)
    lng_err = max(lng_err, check_attn(lng32))
    del lng32
    gc.collect()
    torch.cuda.empty_cache()

    def attn_call(inp, backend):
        args = (inp["q"], inp["k_pages"], inp["v_pages"], inp["fmt"], inp["ptab"],
                inp["lens"])
        return lambda: paged_attn.paged_decode_attn(*args, scale=inp["scale"],
                                                    backend=backend)

    att_ms = time_graph_ms(attn_call(att, "kernel"), repeats=100)
    att_plain_ms = time_ms(attn_call(att, "plain"), repeats=5, warmup=1)
    lng_ms = time_graph_ms(attn_call(lng, "kernel"), repeats=100)
    lng_plain_ms = time_ms(attn_call(lng, "plain"), repeats=3, warmup=1)
    att_bytes, att_ops = attn_bytes_ops(B, H, KV, Dh, lay.page_size, P, lens)
    lng_bytes, lng_ops = attn_bytes_ops(B, H, KV, Dh, lay.page_size, lp, long_lens)
    del lng
    gc.collect()
    torch.cuda.empty_cache()

    enc_bound, enc_by = bound(enc_bytes, enc_ops)
    att_bound, att_by = bound(att_bytes, att_ops)
    lng_bound, lng_by = bound(lng_bytes, lng_ops)
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
         "library_ms": None,
         "split_tokens": paged_attn.SPLIT_TOKENS,
         "timing": "CUDA graph replay, L2 flushed"},
        {"name": "paged_decode_attn_long_context", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:157",
         "shape": f"B={B} H={H} KV={KV} Dh={Dh} page={lay.page_size} P={lp} "
                  f"int8, lens={long_lens[0]} x {B} (the serving path's kernel "
                  "at a long context, which no path of this script runs)",
         "on_path": False,
         "max_abs_err": lng_err, "ms": lng_ms, "plain_ms": lng_plain_ms,
         "bound_ms": lng_bound, "bound_by": lng_by, "bytes": lng_bytes,
         "library_ms": None,
         "split_tokens": paged_attn.SPLIT_TOKENS,
         "timing": "CUDA graph replay, L2 flushed"},
    ]
    say("checks", small_shapes=small, attn_max_abs_err_small=attn_err_small,
        attn_split_tokens=paged_attn.SPLIT_TOKENS,
        attn_two_launches_bit_equal=True, attn_empty_rows_exactly_0=True,
        tolerances={"encode_bytes": 0, "encode_float_sums_rel": SUM_RTOL,
                    "attn_abs": ATTN_TOL},
        main_path=[{k: r[k] for k in ("name", "shape", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows])
    return rows


# ---------------------------------------------------------------------------
# the training quantizer, K1 and K1b
# ---------------------------------------------------------------------------

def _i32(v):
    return torch.tensor(v, dtype=torch.int32, device=DEV)


def _stats_match(sk, sp, n):
    """count/nonzero/overflow/max_abs exact (counts past 2^24 to one ulp of
    the float32 they are written in), float sums to SUM_RTOL; returns the
    largest relative difference of a float sum."""
    exact = [0, 1, 2, 6]
    if n < (1 << 24):
        ok = torch.equal(sk[exact], sp[exact])
    else:
        ulp = torch.nextafter(sp[:3], torch.full_like(sp[:3], math.inf)) - sp[:3]
        ok = (bool(((sk[:3] - sp[:3]).abs() <= ulp).all())
              and bool(sk[6] == sp[6]))
    if not ok:
        raise AssertionError(f"quantizer: count/nonzero/overflow/max_abs "
                             f"{sk[exact].tolist()} vs plain {sp[exact].tolist()}")
    rel = float(((sk[3:6] - sp[3:6]).abs() / sp[3:6].abs().clamp(min=1e-30)).max())
    if rel > SUM_RTOL:
        raise AssertionError(f"quantizer: float sums differ by {rel:.3g} "
                             f"relative (> {SUM_RTOL})")
    return rel


def _bits_name(bits):
    if bits is None:
        return "nearest"
    return "Philox" if isinstance(bits, dps_quant.Philox) else "bits operand"


def check_quant(x, il, fl, bits=None, *, stats=True):
    """One K1/K1b configuration, kernel vs plain on the card: q bit-equal,
    statistics per ``_stats_match``; with statistics, a second launch gives
    the same bits.  ``bits``: None (nearest), a tensor (K1) or a Philox
    stream (K1b).  Returns (the largest |q_kernel - q_plain|, the largest
    relative difference of a float sum)."""
    il, fl = _i32(il), _i32(fl)
    qk, sk = dps_quant.dps_quant(x, il, fl, bits, compute_stats=stats,
                                 backend="kernel")
    qp, sp = dps_quant.dps_quant(x, il, fl, bits, compute_stats=stats,
                                 backend="plain")
    torch.cuda.synchronize()
    iv = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(qk.view(iv), qp.view(iv)):
        raise AssertionError(
            f"quantizer: q differs from the plain version in "
            f"{int((qk.view(iv) != qp.view(iv)).sum())} of {x.numel()} values "
            f"({x.dtype}, {_bits_name(bits)})")
    err = float((qk.to(torch.float32) - qp.to(torch.float32)).abs().max()) \
        if x.numel() else 0.0
    if not stats:
        if sk is not None:
            raise AssertionError("compute_stats=False returned statistics")
        return err, 0.0
    rel = _stats_match(sk, sp, x.numel())
    qk2, sk2 = dps_quant.dps_quant(x, il, fl, bits, backend="kernel")
    if not (torch.equal(qk, qk2) and torch.equal(sk, sk2)):
        raise AssertionError("quantizer: two launches gave different bits")
    return err, rel


def check_prng_equals_bits(x, il, fl, seed):
    """K1b equals K1 fed ``philox_bits`` of the same seed, q and stats."""
    il, fl = _i32(il), _i32(fl)
    a, sa = dps_quant.dps_quant(x, il, fl, dps_quant.Philox(seed),
                                backend="kernel")
    b, sb = dps_quant.dps_quant(x, il, fl, dps_quant.philox_bits(seed, x.numel(), DEV),
                                backend="kernel")
    if not (torch.equal(a, b) and torch.equal(sa, sb)):
        raise AssertionError("K1b differs from K1 fed the same Philox words")


def check_unbiased(n=1 << 20, seeds=64, il=2, fl=6):
    """Stochastic rounding is unbiased: over ``seeds`` K1b launches the mean
    of q - clip(x), summed over all elements, lies within 4 sigma of 0 (sigma
    from the per-element Bernoulli variance).  Returns the bias in units of
    sigma."""
    g = torch.Generator(device=DEV).manual_seed(5)
    x = torch.randn(n, generator=g, device=DEV) * 0.5
    ilt, flt = _i32(il), _i32(fl)
    acc = torch.zeros(n, dtype=torch.float64, device=DEV)
    for s in range(seeds):
        q, _ = dps_quant.dps_quant(x, ilt, flt, dps_quant.Philox(1000 + s),
                                   compute_stats=False, backend="kernel")
        acc += q.to(torch.float64)
    span = 2.0 ** (il - 1 + fl)
    y = (x.to(torch.float64) * 2.0 ** fl).clamp(-span, span - 1)
    p = y - torch.floor(y)
    dev_ = acc / seeds - y * 2.0 ** -fl
    sigma = float(torch.sqrt((p * (1 - p)).sum() / seeds)) * 2.0 ** -fl
    z = float(dev_.sum()) / sigma
    if abs(z) > 4.0:
        raise AssertionError(f"K1b: mean of q over {seeds} seeds is {z:.2f} "
                             "sigma from clip(x)")
    return z


def quant_row(name, shape, x, il, fl, bits, err, rel, nbytes, nops):
    """One ``kernels`` row: K1/K1b at ``x``'s shape, timed with and without
    statistics beside the plain version."""
    args = (x, _i32(il), _i32(fl), bits)
    ms = time_ms(lambda: dps_quant.dps_quant(*args, backend="kernel"), repeats=10)
    ms_nostats = time_ms(lambda: dps_quant.dps_quant(
        *args, compute_stats=False, backend="kernel"), repeats=10)
    plain_ms = time_ms(lambda: dps_quant.dps_quant(*args, backend="plain"),
                       repeats=3, warmup=1)
    bound_ms, by = bound(nbytes, nops)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
            "replaces": "src/repro/kernels/dps_quant.py:288",
            "shape": shape, "max_abs_err": err, "stats_max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "ms_no_stats": ms_nostats,
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "library_ms": None}


def quant_checks(cfg):
    """K1/K1b at small shapes and at the training paths'; returns their two
    ``kernels`` rows (launches filled in by the training phases)."""
    rng = np.random.default_rng(1)

    def draw(n, dtype, scale=4.0, offset=0):
        # ``offset`` > 0 gives a contiguous view whose data pointer is not
        # 16-byte aligned: the kernel's scalar path
        v = rng.standard_normal(n + offset).astype(np.float32) * scale
        v[::7] = 0.0
        return torch.from_numpy(v).to(DEV).to(dtype)[offset:]

    def npbits(n):
        return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                                .view(np.int32)).to(DEV)

    small = []
    worst = 0.0
    for n in (1, 3, 1023, 100_003, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                x = draw(n, dtype, offset=offset)
                bits = npbits(n)
                for stats in (False, True):
                    for src in (None, bits, dps_quant.Philox(12345 + n)):
                        worst = max(worst, check_quant(x, 3, 9, src,
                                                       stats=stats)[1])
                check_prng_equals_bits(x, 3, 9, seed=777 + n)
            small.append(f"n={n} {dtype}")
    z = check_unbiased()

    # --- the training paths' shapes ---
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    w_in, w_in_layer, tap = L * D * F, D * F, 2 * 512 * D
    rels, errs = {}, {}
    # LeNet's (K1, stochastic, a bits operand): its largest weight leaf,
    # fc1_w 800x500 fp32, and its first activation tap, 64x20x12x12 fp32
    for name, n in (("lenet_fc1_w", 800 * 500), ("lenet_tap_c1", 64 * 20 * 144)):
        x = draw(n, torch.float32, scale=0.05)
        errs[name], rels[name] = check_quant(x, 8, 12, npbits(n))
        check_quant(x, 8, 16, npbits(n), stats=False)
    # the LM's tap: bf16 residual stream, <IL, FL> as the acts domain starts
    x = draw(tap, torch.bfloat16, scale=1.0)
    errs["tap_nearest"], rels["tap_nearest"] = check_quant(x, 8, 12)
    errs["tap_k1b"], rels["tap_k1b"] = check_quant(x, 8, 12, dps_quant.Philox(3))
    check_quant(x, 8, 16, dps_quant.Philox(4), stats=False)    # the backward tap
    check_prng_equals_bits(x, 8, 12, seed=3)
    tap_args = (x, _i32(8), _i32(12), dps_quant.Philox(3))
    tap_ms = time_ms(lambda: dps_quant.dps_quant(*tap_args, backend="kernel"),
                     repeats=50)
    tap_plain_ms = time_ms(lambda: dps_quant.dps_quant(*tap_args, backend="plain"),
                           repeats=5, warmup=1)
    del x

    # The largest weight leaf, fp32, drawn like init_params' normal init.
    # K1b quantizes it in one launch; with a bits operand quantize_tree
    # draws and quantizes it one layer at a time, so K1's launch is one
    # layer's slice, D x F.
    g = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn(w_in, generator=g, device=DEV) * D ** -0.5
    x[::11] = 0.0
    il, fl = 2, 14
    errs["w_in_k1b"], rels["w_in_k1b"] = check_quant(x, il, fl, dps_quant.Philox(5))
    check_quant(x, il, fl, stats=False)
    check_prng_equals_bits(x, il, fl, seed=5)
    bits = torch.randint(-2**31, 2**31, (w_in,), dtype=torch.int32,
                         device=DEV, generator=g)
    errs["w_in_k1"], rels["w_in_k1"] = check_quant(x, il, fl, bits)
    del bits
    # bytes: x in, q out (fp32), <IL, FL> in, 7 stats out; K1 also reads the
    # bits.  Operations: ~24 fp32 operations an element (scale, two clips,
    # round, rescale; the statistics' subtract, abs, compare, divide, three
    # sums and the max); K1b adds Philox4x32-10, 10 rounds of ~10 integer
    # operations for every 4 elements, counted here at the fp32 rate.
    k1b = quant_row("dps_quantize_onchip_prng",
                    f"w_in leaf {L}x{D}x{F} = {w_in} fp32, Philox bits in the "
                    "kernel, statistics on (one launch per leaf on the LM path)",
                    x, il, fl, dps_quant.Philox(5), errs["w_in_k1b"],
                    rels["w_in_k1b"], 8 * w_in + 8 + 28, 49 * w_in)
    k1b.update(tap_shape=f"2x512x{D} bf16", tap_ms=tap_ms,
               tap_plain_ms=tap_plain_ms)
    xl = x.view(L, D, F)[L // 2]                      # one layer, contiguous
    bits = torch.randint(-2**31, 2**31, (w_in_layer,), dtype=torch.int32,
                         device=DEV, generator=g)
    errs["w_in_layer_k1"], rels["w_in_layer_k1"] = check_quant(xl, il, fl, bits)
    k1 = quant_row("dps_quantize",
                   f"one layer of the w_in leaf, {D}x{F} = {w_in_layer} fp32, "
                   "a bits operand, statistics on (the LM path's K1 launch "
                   "under --rounding-bits operand)",
                   xl, il, fl, bits, errs["w_in_layer_k1"],
                   rels["w_in_layer_k1"], 12 * w_in_layer + 8 + 28,
                   24 * w_in_layer)
    del x, xl, bits
    gc.collect()
    torch.cuda.empty_cache()

    rows = [k1, k1b]
    say("quantize", small_shapes=small, small_worst_sum_rel=worst,
        unbiased_sigma=z, main_path_q_max_abs_err=errs,
        main_path_sum_rel=rels,
        tolerances={"q": "bit-equal", "float_sums_rel": SUM_RTOL,
                    "counts": "exact below 2^24, 1 ulp above"},
        main_path=[{k: r[k] for k in ("name", "shape", "ms", "ms_no_stats",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows],

        tap={"ms": tap_ms, "plain_ms": tap_plain_ms})
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


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _reset_quant_counts():
    dps_quant.quantize_launch_count = 0
    dps_quant.quantize_prng_launch_count = 0


def _quant_counts():
    return {"dps_quantize": dps_quant.quantize_launch_count,
            "dps_quantize_onchip_prng": dps_quant.quantize_prng_launch_count}


def lenet():
    """The paper's app on the card: K1 on every event, then kernel vs plain
    under nearest and under stochastic rounding."""
    from repro_torch.apps import mnist as app
    from repro_torch.data import MNISTLike
    data = MNISTLike(batch=64, seed=0, n_train=2048, n_test=512)
    qcfg = dataclasses.replace(app.paper_quant_config(), onchip_prng=False)
    steps = 20
    t0 = time.perf_counter()
    _reset_quant_counts()                      # the counted run
    hist = app.train_mnist(qcfg, steps=steps, data=data, device=DEV)
    torch.cuda.synchronize()
    launches = _quant_counts()
    wall = time.perf_counter() - t0
    # per step: 8 leaves x (weights, grads, re-snap) + 4 taps forward and
    # backward + the logit gradient's statistics
    per_step = 8 * 3 + 4 * 2 + 1
    if launches != {"dps_quantize": per_step * steps, "dps_quantize_onchip_prng": 0}:
        raise AssertionError(f"LeNet: quantizer launches {launches}, wanted "
                             f"{per_step} x {steps} on K1")
    if not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError("LeNet: a loss is not finite")

    # kernel vs plain: the stochastic runs draw the same operand bits (the
    # same seeded generator on the card), so q is bit-equal there too
    fmt_keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
    compared = {}
    for rounding in ("nearest", "stochastic"):
        runs = {}
        for backend in ("kernel", "plain"):
            q = dataclasses.replace(app.paper_quant_config(rounding=rounding),
                                    onchip_prng=False, backend=backend)
            runs[backend] = app.train_mnist(q, steps=3, data=data, device=DEV)
        for k in fmt_keys:
            if runs["kernel"][k] != runs["plain"][k]:
                raise AssertionError(f"LeNet kernel vs plain ({rounding}): {k} "
                                     f"{runs['kernel'][k]} vs {runs['plain'][k]}")
        loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                       zip(runs["kernel"]["loss"], runs["plain"]["loss"]))
        if loss_rel > LENET_LOSS_RTOL:
            raise AssertionError(f"LeNet kernel vs plain ({rounding}): loss "
                                 f"differs by {loss_rel:.3g} relative "
                                 f"(> {LENET_LOSS_RTOL})")
        compared[rounding] = {"steps": 3, "formats_equal": True,
                              "loss_max_rel": loss_rel,
                              "loss": runs["kernel"]["loss"]}
    say("lenet", steps=steps, wall_s=wall, loss_first=hist["loss"][0],
        loss_last=hist["loss"][-1], launches=launches,
        formats_last={k: hist[k][-1] for k in fmt_keys},
        kernel_vs_plain=compared, tolerance=LENET_LOSS_RTOL)
    return launches


def train_lm(cfg, rounding_bits, steps):
    """The LM trainer's CLI at full size, every quantization event on K1b
    (``onchip``) or on K1 (``operand``)."""
    from repro_torch.launch import train as train_cli
    argv = ["--arch", "llama3_2_3b", "--steps", str(steps), "--batch", "2",
            "--seq", "512", "--optimizer", "sgd", "--log-every", "1",
            "--rounding-bits", rounding_bits]
    _reset_quant_counts()                      # the counted run
    out = train_cli.main(argv)
    launches = _quant_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"LM training: losses {losses}")
    # 8 quantized leaves x (weights, grads, re-snap) + one tap a layer
    # forward and one backward.  The recompute under torch.utils.checkpoint
    # stops once the block's saved tensors are back, before the tap (which
    # saves none).  With a bits operand each of the 7 stacked leaves is
    # quantized one layer at a time (the embedding is one launch).
    L = cfg.n_layers
    if rounding_bits == "onchip":
        per_step, want = 8 * 3 + 2 * L, "dps_quantize_onchip_prng"
    else:
        per_step, want = 3 * (1 + 7 * L) + 2 * L, "dps_quantize"
    wanted = {"dps_quantize": 0, "dps_quantize_onchip_prng": 0}
    wanted[want] = per_step * steps
    if out["quantizer_launches_per_step"] != [per_step] * steps or \
            launches != wanted:
        raise AssertionError(f"LM training: quantizer launches {launches}, "
                             f"{out['quantizer_launches_per_step']} a step; "
                             f"wanted {per_step} a step on {want}")
    traj = [{k: h[k] for k in ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")}
            for h in hist]
    say("train", command="python -m repro_torch.launch.train " + " ".join(argv),
        params=out["params"], losses=losses,
        first_step_s=out["first_step_s"],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        tokens_per_s_after_first=out["tokens_per_s_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"], formats=traj,
        launches=launches, launches_per_step=per_step)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the wire path: K2/K2b, K3b, K4, the collectives, data-parallel training
# ---------------------------------------------------------------------------

def check_wire_quant(x, il, fl, bits=None, *, stats=True, out_offset=None):
    """One K2/K2b configuration, kernel vs plain on the card: wire bytes
    equal, statistics per ``_stats_match``, a second launch equal.
    ``out_offset`` writes the kernel's wire into a larger buffer at that
    offset (an unaligned slot takes the scalar path).  Returns (the largest
    |byte_kernel - byte_plain|, the largest relative difference of a float
    sum)."""
    il, fl = _i32(il), _i32(fl)
    out = None
    if out_offset is not None:
        buf = torch.full((x.numel() + out_offset + 5,), 77, dtype=torch.int8,
                         device=DEV)
        out = buf[out_offset:out_offset + x.numel()].view(x.shape)
    wk, sk = dps_quant.dps_quant_wire(x, il, fl, bits, compute_stats=stats,
                                      out=out, backend="kernel")
    wp, sp = dps_quant.dps_quant_wire(x, il, fl, bits, compute_stats=stats,
                                      backend="plain")
    torch.cuda.synchronize()
    if not torch.equal(wk, wp):
        raise AssertionError(
            f"wire quantizer: {int((wk != wp).sum())} of {x.numel()} bytes "
            f"differ ({x.dtype}, {_bits_name(bits)})")
    if out_offset is not None and not (bool((buf[:out_offset] == 77).all())
                                       and bool((buf[-5:] == 77).all())):
        raise AssertionError("wire quantizer wrote outside its slot")
    err = _byte_err(wk, wp)
    if not stats:
        if sk is not None:
            raise AssertionError("compute_stats=False returned statistics")
        return err, 0.0
    rel = _stats_match(sk, sp, x.numel())
    wk2, sk2 = dps_quant.dps_quant_wire(x, il, fl, bits, backend="kernel")
    if not (torch.equal(wk, wk2) and torch.equal(sk, sk2)):
        raise AssertionError("wire quantizer: two launches gave different bits")
    return err, rel


def _byte_err(a, b):
    """The largest |a - b| of two int8 tensors, as a float."""
    if not a.numel():
        return 0.0
    return float((a.to(torch.int16) - b.to(torch.int16)).abs().max())


def _reduce_body(wire, quantum):
    """The body ``reduce_plan`` gives K4 for this view of the rows."""
    n, chunk = wire.shape
    aligned = wire.data_ptr() % 16 == 0        # the output is a fresh tensor
    return dps_quant.reduce_plan(n, chunk, quantum,
                                 wire.stride(0) if n > 1 else chunk,
                                 aligned).body


def check_reduce(wire, tab, tg, quantum, body=None):
    """K4 vs plain on the card: the means bit-equal, and the launch on the
    body the plan gives (``body``, if given, too) by the TMA counter."""
    want = _reduce_body(wire, quantum)
    if body is not None and body != want:
        raise AssertionError(f"wire reduce: planned the {want} body, "
                             f"wanted {body}")
    tma0 = dps_quant.reduce_tma_launch_count
    mk = dps_quant.dps_wire_reduce(wire, tab, tg, quantum=quantum,
                                   backend="kernel")
    took = "tma" if dps_quant.reduce_tma_launch_count > tma0 else "stride"
    mp = dps_quant.dps_wire_reduce(wire, tab, tg, quantum=quantum,
                                   backend="plain")
    torch.cuda.synchronize()
    if took != want:
        raise AssertionError(f"wire reduce: launched the {took} body, "
                             f"planned {want}")
    if not torch.equal(mk.view(torch.int32), mp.view(torch.int32)):
        raise AssertionError(f"wire reduce: {int((mk != mp).sum())} of "
                             f"{mk.numel()} means differ (n={wire.shape[0]}, "
                             f"quantum={quantum}, {took} body)")
    return float((mk - mp).abs().max()) if mk.numel() else 0.0


def torch_sum_ms(view):
    """``torch.sum`` of the int8 rows into fp32: the same bytes as K4, not
    the same function (no decode, no mean), a yardstick the port never
    calls."""
    return time_ms(lambda: torch.sum(view, dim=0, dtype=torch.float32),
                   repeats=10)


def check_group_prng(x, tab, tg, src, quantum, *, mask=None, stats=True):
    """K3b vs plain, and K3b vs K3 fed the same Philox words: bytes equal,
    statistics exact (counts) and to SUM_RTOL (sums)."""
    kw = dict(quantum=quantum, emit_stats=stats)
    wk, sk = dps_quant.dps_quant_group_wire(x, tab, tg, src, mask,
                                            backend="kernel", **kw)
    wp, sp = dps_quant.dps_quant_group_wire(x, tab, tg, src, mask,
                                            backend="plain", **kw)
    words = dps_quant.group_philox_bits(src, tg, quantum)
    wb, sb = dps_quant.dps_quant_group_wire(x, tab, tg, words, mask,
                                            backend="kernel", **kw)
    torch.cuda.synchronize()
    if not (torch.equal(wk, wp) and torch.equal(wk, wb)):
        raise AssertionError(f"K3b: bytes differ from the plain version or "
                             f"from K3 fed the same words (quantum {quantum})")
    rel = 0.0
    if stats:
        exact = [0, 1, 2, 6]
        if not (torch.equal(sk[:, exact], sp[:, exact])
                and torch.equal(sk[:, exact], sb[:, exact])):
            raise AssertionError("K3b: count/nonzero/overflow/max_abs differ")
        rel = max(float(((sk[:, 3:6] - o[:, 3:6]).abs()
                         / o[:, 3:6].abs().clamp(min=1e-30)).max())
                  for o in (sp, sb))
        if rel > SUM_RTOL:
            raise AssertionError(f"K3b: float sums differ by {rel:.3g}")
    return rel


def _layout_bits(rng, sizes, n, quantum):
    """A group-aligned layout of ``sizes`` over ``n`` ranks and its tables
    on the card."""
    from repro_torch.dist import group_layout
    lay = group_layout(sizes, n_chunks=n, quantum=quantum)
    tg = torch.from_numpy(lay.tile_groups()).to(DEV)
    goff = torch.tensor(lay.offsets, dtype=torch.int64, device=DEV)
    il = rng.integers(1, 5, len(sizes))
    tab = torch.from_numpy(np.stack([il, 8 - il], 1).astype(np.int32)).to(DEV)
    return lay, tg, goff, tab


def wire_kernel_checks(cfg):
    """K2/K2b, K3b and K4 against their plain versions at small shapes and
    at the wire path's; the exact counts of K3 on a group past 2^24
    elements.  Returns the four ``kernels`` rows (launches filled in by the
    wire phases)."""
    rng = np.random.default_rng(2)

    def draw(n, dtype, scale=4.0, offset=0):
        v = rng.standard_normal(n + offset).astype(np.float32) * scale
        v[::7] = 0.0
        return torch.from_numpy(v).to(DEV).to(dtype)[offset:]

    def npbits(n):
        return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                                .view(np.int32)).to(DEV)

    small, worst = [], 0.0
    # K2 / K2b: sizes, types, alignment, bit sources, saturation, statistics
    for n in (1, 3, 1023, 100_003, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                x = draw(n, dtype, offset=offset)
                bits = npbits(n)
                for il, fl in ((3, 5), (6, 6)):          # (6, 6) saturates
                    for stats in (False, True):
                        for src in (None, bits, dps_quant.Philox(99 + n),
                                    dps_quant.Philox(99 + n, offset=6),
                                    dps_quant.Philox(99 + n, offset=3)):
                            worst = max(worst, check_wire_quant(
                                x, il, fl, src, stats=stats)[1])
                worst = max(worst, check_wire_quant(
                    x, 3, 5, dps_quant.Philox(5), out_offset=3)[1])
                worst = max(worst, check_wire_quant(x, 3, 5, out_offset=16)[1])
                for off in (0, 3, 8):
                    a, sa = dps_quant.dps_quant_wire(
                        x, _i32(3), _i32(5), dps_quant.Philox(11, off),
                        backend="kernel")
                    b, sb = dps_quant.dps_quant_wire(
                        x, _i32(3), _i32(5),
                        dps_quant.philox_bits(11, n, DEV, offset=off),
                        backend="kernel")
                    if not torch.equal(a, b):
                        raise AssertionError("K2b differs from K2 fed the "
                                             "same Philox words")
                    _stats_match(sa, sb, n)
            small.append(f"wire n={n} {dtype}")
    # NaN and infinities: the same byte from the kernel and the plain version
    xn = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.5, -0.25,
                       float("nan"), 3.0, 1e9], device=DEV)
    check_wire_quant(xn, 3, 5, stats=False)
    nan_byte = int(dps_quant.dps_quant_wire(xn, _i32(3), _i32(5),
                                            backend="kernel")[0][0])
    # K4: rank counts, tables, ragged chunks, strided rows; then the TMA
    # body's edges: a chunk shorter than one span, a quantum below the span
    # (an item a tile, neighbours of other formats) and above it (several
    # items a tile, the last shorter when the span does not divide it), a
    # ragged last tile, n = 16 and n = 300 (two 256-row passes of the packed
    # sums), rows at the int8 extremes, a 16-byte row stride from a base
    # off 16 bytes (the grid-stride body)
    for n_ranks, chunk, quantum, groups, stride_pad, base in (
            (1, 4096, 4096, 1, 0, 0), (2, 8192, 4096, 2, 0, 0),
            (3, 1000, 100, 4, 0, 0), (4, 777, 7, 3, 5, 0),
            (5, 4096 * 3, 4096, 3, 4096 * 2, 0), (8, 160, 16, 2, 16, 0),
            (7, 12345, 4096, 2, 0, 0), (6, 64, 16, 4, 3, 0),
            (4, 64, 4096, 1, 0, 0), (4, 4096 * 4, 1024, 5, 0, 0),
            (4, 4096 * 5, 16384, 3, 32, 0), (3, 4112 * 3, 4112, 3, 0, 0),
            (4, 4096 * 2 + 1024, 4096, 3, 0, 0), (16, 4096 * 3, 4096, 3, 0, 0),
            (300, 4096, 4096, 2, 0, 0), (4, 8192, 4096, 2, 13, 3)):
        tiles = -(-chunk // quantum)
        big = torch.from_numpy(rng.integers(
            -128, 127, (n_ranks, base + chunk + stride_pad), dtype=np.int8,
            endpoint=True)).to(DEV)
        big[:, base:base + 3] = 127
        big[:, base + 3:base + 6] = -128
        w = big[:, base:base + chunk]                     # rows stride apart
        il = rng.integers(1, 6, groups)
        tab = torch.from_numpy(np.stack([il, 8 - il], 1).astype(np.int32)).to(DEV)
        tg = torch.from_numpy(np.sort(rng.integers(0, groups, tiles))
                              .astype(np.int32)).to(DEV)
        check_reduce(w, tab, tg, quantum)
        check_reduce(w, tab[:1].contiguous(), None, quantum)
        small.append(f"reduce n={n_ranks} chunk={chunk} q={quantum} G={groups} "
                     f"row_stride={base + chunk + stride_pad} base+{base} "
                     f"{_reduce_body(w, quantum)}")
    # K3b: per-group streams over layouts, every owner's chunk
    for sizes, n_ranks, quantum, dtype in (((700, 3000, 5), 3, 128, torch.float32),
                                           ((5000, 37, 9000, 1), 4, 4096, torch.float32),
                                           ((301, 77), 2, 6, torch.float32),
                                           ((1000, 2000), 2, 64, torch.bfloat16)):
        lay, tg, goff, tab = _layout_bits(rng, sizes, n_ranks, quantum)
        x = draw(lay.total, dtype, scale=0.5)
        mask = torch.from_numpy((rng.random(lay.total) > 0.1)
                                .astype(np.float32)).to(DEV)
        tpc = lay.chunk // quantum
        for j in range(n_ranks):
            src = dps_quant.GroupPhilox(4242, goff, start=j * lay.chunk,
                                        group_base=j % 2)
            xs = x[j * lay.chunk:(j + 1) * lay.chunk]
            tj = tg[j * tpc:(j + 1) * tpc]
            for stats in (False, True):
                worst = max(worst, check_group_prng(xs, tab, tj, src, quantum,
                                                    stats=stats))
            worst = max(worst, check_group_prng(
                xs, tab, tj, src, quantum,
                mask=mask[j * lay.chunk:(j + 1) * lay.chunk]))
        small.append(f"group prng sizes={sizes} n={n_ranks} q={quantum} {dtype}")

    # K3's counts past 2^24 in one group (about 16.86 M of its 17.2 M
    # elements kept by the mask): float32 partial counts would round
    T, q = 4200, 4096
    xb = draw(T * q, torch.float32, scale=8.0)
    mb = torch.from_numpy((rng.random(T * q) > 0.02).astype(np.float32)).to(DEV)
    tab1 = torch.tensor([[1, 2]], dtype=torch.int32, device=DEV)
    tg1 = torch.zeros(T, dtype=torch.int32, device=DEV)
    _, sk = dps_quant.dps_quant_group_wire(xb, tab1, tg1, None, mb, quantum=q,
                                           backend="kernel")
    _, sp = dps_quant.dps_quant_group_wire(xb, tab1, tg1, None, mb, quantum=q,
                                           backend="plain")
    want = [float(np.float32(int((mb != 0).sum().item()))),
            float(np.float32(int(((xb != 0) & (mb != 0)).sum().item())))]
    if not (torch.equal(sk[:, [0, 1, 2, 6]], sp[:, [0, 1, 2, 6]])
            and sk[0, :2].tolist() == want and want[0] > 1 << 24):
        raise AssertionError(f"K3 counts past 2^24: {sk[0, :3].tolist()} vs "
                             f"plain {sp[0, :3].tolist()}, exact {want}")
    big_counts = {"elements": T * q, "count": float(sk[0, 0]),
                  "nonzero": float(sk[0, 1]), "overflow": float(sk[0, 2])}
    del xb, mb

    # --- the wire path's shapes, llama3.2-3b at full width, 4 ranks ---
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import group_layout
    from repro_torch.models import transformer
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    sizes = tuple(math.prod(d.shape) for d in tree_lib.leaves(defs))
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    w_in = L * D * F
    # K2b on the w_in gradient leaf (grads of a random-init LM are ~1e-4;
    # the wire format of that domain starts at <6, 2> and settles at <1, 7>)
    g = torch.Generator(device=DEV).manual_seed(8)
    x = torch.randn(w_in, generator=g, device=DEV) * 0.02
    x[::11] = 0.0
    il, fl = 1, 7
    errs, rels = {}, {}
    errs["w_in_k2b"], rels["w_in_k2b"] = check_wire_quant(x, il, fl,
                                                          dps_quant.Philox(21))
    wbits = torch.randint(-2**31, 2**31, (w_in,), dtype=torch.int32,
                          device=DEV, generator=g)
    errs["w_in_k2"], rels["w_in_k2"] = check_wire_quant(x, il, fl, wbits)
    errs["w_in_k2_nearest"], rels["w_in_k2_nearest"] = check_wire_quant(x, il, fl)
    check_wire_quant(x, il, fl, dps_quant.Philox(21), stats=False)

    def wire_row(name, bits, nbytes, nops, note):
        key = "w_in_k2b" if "prng" in name else "w_in_k2"
        args = (x, _i32(il), _i32(fl), bits)
        ms = time_ms(lambda: dps_quant.dps_quant_wire(*args, backend="kernel"),
                     repeats=10)
        ms_ns = time_ms(lambda: dps_quant.dps_quant_wire(
            *args, compute_stats=False, backend="kernel"), repeats=10)
        plain_ms = time_ms(lambda: dps_quant.dps_quant_wire(
            *args, backend="plain"), repeats=3, warmup=1)
        extra = {}
        if isinstance(bits, dps_quant.Philox):
            # the bare pipe: nearest rounding, no statistics, the same bytes
            extra["ms_nearest_no_stats"] = time_ms(lambda: dps_quant.dps_quant_wire(
                args[0], args[1], args[2], None, compute_stats=False,
                backend="kernel"), repeats=10)
        b, by = bound(nbytes, nops)
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
                "replaces": "src/repro/kernels/dps_quant.py:288",
                "shape": f"w_in gradient leaf {L}x{D}x{F} = {w_in} fp32 -> "
                         f"int8, {note}, statistics on (leg 1, one launch "
                         "per leaf per rank)",
                "max_abs_err": errs[key], "stats_max_rel_err": rels[key],
                "ms": ms, "plain_ms": plain_ms, "ms_no_stats": ms_ns, **extra,
                "bound_ms": b, "bound_by": by, "bytes": nbytes,
                "library_ms": None}

    # bytes: x in (4 B), wire out (1 B), <IL, FL> in, 7 stats out; K2 also
    # reads the bits (4 B)
    k2b = wire_row("dps_quant_wire_onchip_prng", dps_quant.Philox(21),
                   5 * w_in + 8 + 28, 49 * w_in, "Philox bits in the kernel")
    k2 = wire_row("dps_quant_wire", wbits, 9 * w_in + 8 + 28, 24 * w_in,
                  "a bits operand (--rounding-bits operand)")
    del x, wbits
    gc.collect()
    torch.cuda.empty_cache()

    # K4 on owner 1's [4, c] view of the full tree's per-layer layout
    n_ranks = 4
    lay = group_layout(sizes, n_chunks=n_ranks, quantum=4096)
    c, tpc = lay.chunk, lay.chunk // 4096
    tg = torch.from_numpy(lay.tile_groups()).to(DEV)
    goff = torch.tensor(lay.offsets, dtype=torch.int64, device=DEV)
    il_g = rng.integers(1, 3, len(sizes))
    tab = torch.from_numpy(np.stack([il_g, 8 - il_g], 1).astype(np.int32)).to(DEV)
    stack = torch.randint(-128, 127, (n_ranks, lay.total), dtype=torch.int8,
                          device=DEV, generator=g)
    view = stack.view(n_ranks, n_ranks, c).transpose(0, 1)[1]
    tg1 = tg[tpc:2 * tpc]
    errs["reduce"] = check_reduce(view, tab, tg1, 4096, body="tma")
    red_bytes = n_ranks * c + 4 * c + 4 * tpc + 8 * len(sizes)
    red_ops = (2 * n_ranks + 1) * c
    red_ms = time_ms(lambda: dps_quant.dps_wire_reduce(
        view, tab, tg1, quantum=4096, backend="kernel"), repeats=10)
    red_plain = time_ms(lambda: dps_quant.dps_wire_reduce(
        view, tab, tg1, quantum=4096, backend="plain"), repeats=3, warmup=1)
    red_sum = torch_sum_ms(view)
    part = dps_quant.dps_wire_reduce(view, tab, tg1, quantum=4096,
                                     backend="kernel")
    del stack, view
    gc.collect()
    torch.cuda.empty_cache()
    b, by = bound(red_bytes, red_ops)
    k4 = {"name": "dps_wire_reduce", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
          "replaces": "src/repro/kernels/dps_quant.py:544",
          "shape": f"[{n_ranks}, {c}] int8 (owner 1's strided view of the "
                   f"[{n_ranks}, {lay.total}] stack, row stride {lay.total}) "
                   f"-> fp32 [{c}], {len(sizes)} formats, quantum 4096",
          "max_abs_err": errs["reduce"], "ms": red_ms, "plain_ms": red_plain,
          "bound_ms": b, "bound_by": by, "bytes": red_bytes, "library_ms": None,
          "body": "tma", "torch_sum_ms": red_sum, "torch_sum_note": TORCH_SUM_NOTE}

    # K3b on that owner's mean chunk, as leg 2 launches it (no statistics)
    src = dps_quant.GroupPhilox(31, goff, start=c)
    out = torch.empty(c, dtype=torch.int8, device=DEV)
    wk, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, src, None,
                                           quantum=4096, emit_stats=False,
                                           out=out, backend="kernel")
    wp, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, src, None,
                                           quantum=4096, emit_stats=False,
                                           backend="plain")
    if not torch.equal(wk, wp):
        raise AssertionError("K3b at the path's shape differs from its plain "
                             "version")
    errs["k3b"] = _byte_err(wk, wp)
    del wp
    # K3 with a bits operand on that chunk, as leg 2 launches it under
    # --rounding-bits operand
    obits = torch.randint(-2**31, 2**31, (c,), dtype=torch.int32, device=DEV,
                          generator=g)
    wk, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, obits, None,
                                           quantum=4096, emit_stats=False,
                                           out=out, backend="kernel")
    wp, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, obits, None,
                                           quantum=4096, emit_stats=False,
                                           backend="plain")
    if not torch.equal(wk, wp):
        raise AssertionError("K3 with a bits operand at the wire path's shape "
                             "differs from its plain version")
    errs["k3_operand"] = _byte_err(wk, wp)
    del wp, obits
    g3_bytes = 4 * c + c + 4 * tpc + 8 * len(sizes) + 8 * len(sizes)
    g3_ms = time_ms(lambda: dps_quant.dps_quant_group_wire(
        part, tab, tg1, src, None, quantum=4096, emit_stats=False, out=out,
        backend="kernel"), repeats=10)
    g3_plain = time_ms(lambda: dps_quant.dps_quant_group_wire(
        part, tab, tg1, src, None, quantum=4096, emit_stats=False,
        backend="plain"), repeats=2, warmup=1)
    b, by = bound(g3_bytes, 37 * c)
    k3b = {"name": "dps_group_wire_encode_onchip_prng", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
           "replaces": "src/repro/kernels/dps_quant.py:482",
           "shape": f"one owner chunk of {c} fp32 -> int8, {len(sizes)} "
                    "formats, quantum 4096, Philox per group, no statistics "
                    "(leg 2)",
           "max_abs_err": errs["k3b"], "ms": g3_ms, "plain_ms": g3_plain,
           "bound_ms": b, "bound_by": by, "bytes": g3_bytes, "library_ms": None}
    del part, out
    gc.collect()
    torch.cuda.empty_cache()

    rows = [k2, k2b, k3b, k4]
    say("wire_kernels", small_shapes=small, small_worst_sum_rel=worst,
        nan_byte=nan_byte, k3_counts_past_2_24=big_counts,
        main_path_sum_rel=rels, main_path_max_abs_err=errs,
        tolerances={"wire_bytes": "bit-equal", "reduce_mean": "bit-equal",
                    "float_sums_rel": SUM_RTOL,
                    "counts": "exact below 2^24, 1 ulp above (K1/K2); "
                              "exact (K3)"},
        main_path=[{k: r[k] for k in ("name", "shape", "ms", "plain_ms",
                                      "bound_ms", "bound_by")} for r in rows])
    return rows


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _ragged_tree(rng, n):
    """n ranks' trees of leaves that are not multiples of the quantum."""
    shapes = {"a": (7, 13), "b": (4097,), "c": {"d": (300, 5), "e": (1,)},
              "f": (2, 3, 4096)}
    return [_map_shapes(shapes, lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.3).to(DEV))
        for _ in range(n)]


def wire_collectives():
    """``dps_allreduce_mean_tree`` on the card, kernels vs plain versions,
    on a ragged tree over 4 ranks: scalar and per-leaf formats, nearest and
    stochastic rounding (Philox in the kernels, and a bits operand drawn on
    the card, the same words for both sides); the means bit-equal, the
    statistics exact and to SUM_RTOL.  Then ``ProcessGroupTransport`` over
    NCCL with one rank against ``StackedTransport(1)``."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.fixed_point import FixedPointFormat
    from repro_torch.dist import (ProcessGroupTransport, StackedTransport,
                                  dps_allreduce_mean_tree, psum_stats)
    rng = np.random.default_rng(4)
    n = 4
    trees = _ragged_tree(rng, n)
    G = len(tree_lib.leaves(trees[0]))
    fmts = {"scalar": FixedPointFormat.create(2, 6, DEV),
            "per_leaf": FixedPointFormat(
                torch.tensor([2, 1, 3, 2, 1, 2][:G], dtype=torch.int32, device=DEV),
                torch.tensor([6, 7, 5, 6, 7, 6][:G], dtype=torch.int32, device=DEV))}
    tr = StackedTransport(n, DEV)
    compared = {}
    for mode, onchip in (("nearest", True), ("stochastic", True),
                         ("stochastic", False)):
        for name, fmt in fmts.items():
            out = {}
            for backend in ("kernel", "plain"):
                m, st = dps_allreduce_mean_tree(trees, fmt, tr, 1234, mode=mode,
                                                backend=backend,
                                                onchip_prng=onchip)
                out[backend] = (m, psum_stats(st, tr))
            (mk, sk), (mp, sp) = out["kernel"], out["plain"]
            for a, b in zip(tree_lib.leaves(mk), tree_lib.leaves(mp)):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"tree all-reduce ({name}, {mode}): "
                                         "kernel mean differs from plain")
            for f in ("count", "nonzero", "overflow", "max_abs"):
                if not torch.equal(getattr(sk, f), getattr(sp, f)):
                    raise AssertionError(f"tree all-reduce ({name}, {mode}): "
                                         f"{f} differs")
            rel = max(float(((getattr(sk, f) - getattr(sp, f)).abs()
                             / getattr(sp, f).abs().clamp(min=1e-30)).max())
                      for f in ("abs_err_sum", "rel_err_sum", "abs_sum"))
            if rel > SUM_RTOL:
                raise AssertionError(f"tree all-reduce: sums differ by {rel}")
            exact = sum(t["b"] for t in trees) / n
            src = "" if mode == "nearest" else ("/philox" if onchip else "/operand")
            compared[f"{name}/{mode}{src}"] = {
                "mean_bit_equal": True, "stats_sum_rel": rel,
                "b_max_abs_err_vs_fp32_mean": float((mk["b"] - exact).abs().max())}
    # one rank: torch.distributed (NCCL) against the stacked transport
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            one = trees[:1]
            for mode in ("nearest", "stochastic"):
                for fmt in fmts.values():
                    a, sa = dps_allreduce_mean_tree(one, fmt, ProcessGroupTransport(),
                                                    77, mode=mode)
                    b, sb = dps_allreduce_mean_tree(one, fmt, StackedTransport(1, DEV),
                                                    77, mode=mode)
                    if not all(torch.equal(x, y) for x, y in
                               zip(tree_lib.leaves(a), tree_lib.leaves(b))):
                        raise AssertionError("ProcessGroupTransport (NCCL, 1 "
                                             "rank) differs from StackedTransport(1)")
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    say("wire_collectives", ranks=n, leaves=G, compared=compared,
        nccl_one_rank_equals_stacked=True)


def _wire_step_launches(cfg, n_ranks, rounding_bits, zero_buckets=0):
    """Kernel launches a step of the int8-wire data-parallel step, per-layer
    formats, stochastic rounding: every quantizer event of the replicated
    step with the forward/backward and the raw-gradient statistics once per
    rank, the wire quantizer once per leaf per rank, K4 and the grouped
    encoder once per owner.  ``onchip``: K1b, K2b, K3b; ``operand``: K1 (a
    stacked leaf one layer at a time, as ``quantize_tree`` bounds its bits),
    K2, K3.  ``zero_buckets`` > 0: the ZeRO step over that many buckets —
    K4 and the leg-2 encode once per owner per bucket, and no
    optimizer-input snap (the norm scales keep the params leg in fp32)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import transformer
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    pred = QuantPolicy().param_predicate()
    paths = tree_lib.leaves_with_path(defs)
    G, L = len(paths), cfg.n_layers
    quantized = [d.shape for p, d in paths if pred(p, d)]
    if rounding_bits == "onchip":
        events = len(quantized)
    else:
        events = sum(s[0] if len(s) >= 3 and s[0] > 4 and math.prod(s) > 1 << 22
                     else 1 for s in quantized)
    sfx = "_onchip_prng" if rounding_bits == "onchip" else ""
    out = {k: 0 for k in ("dps_quantize", "dps_quantize_onchip_prng",
                          "dps_quant_wire", "dps_quant_wire_onchip_prng",
                          "dps_group_wire_encode",
                          "dps_group_wire_encode_onchip_prng")}
    snaps, owners = (2, n_ranks * zero_buckets) if zero_buckets else (3, n_ranks)
    out.update({"dps_quantize" + sfx: snaps * events + n_ranks * (2 * L + events),
                "dps_quant_wire" + sfx: n_ranks * G,
                "dps_group_wire_encode" + sfx: owners,
                "dps_wire_reduce": owners})
    return out


def _all_k4_on_tma(launches, what):
    """Every K4 launch of a full-width run took the TMA body."""
    k4, tma = launches["dps_wire_reduce"], dps_quant.reduce_tma_launch_count
    if k4 < 1 or tma != k4:
        raise AssertionError(f"{what}: {tma} of {k4} K4 launches took the "
                             "TMA body")


def wire_argv(steps=4, n_ranks=4, rounding_bits="onchip", *extra):
    """``launch.train`` arguments of the full-width int8-wire run."""
    return ["--arch", "llama3_2_3b", "--steps", str(steps), "--batch",
            str(n_ranks), "--seq", "512", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", str(n_ranks),
            "--rounding-bits", rounding_bits, "--log-every", "1", *extra]


def train_wire(cfg, steps=4, n_ranks=4, rounding_bits="onchip",
               ckpt_dir=None):
    """The int8-wire data-parallel trainer's CLI at full size: n_ranks ranks
    on the card, batch 1 x 512 each, per-layer wire formats; K1b/K2b/K3b/K4,
    or K1/K2/K3/K4 with ``rounding_bits="operand"``.  ``ckpt_dir``: the run
    also writes its final checkpoint there (run A of ``ckpt_resume``).
    Returns the launches, the losses and the CLI's summary."""
    from repro_torch.launch import train as train_cli
    argv = wire_argv(steps, n_ranks, rounding_bits,
                     *(["--ckpt-dir", ckpt_dir] if ckpt_dir else []))
    train_cli.reset_launch_counts()            # the counted run
    dps_quant.reduce_tma_launch_count = 0
    out = train_cli.main(argv)
    launches = train_cli.launch_counts()
    _all_k4_on_tma(launches, "wire training")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"wire training: losses {losses}")
    if not out["wire_sync"]:
        raise AssertionError("wire training: the int8 wire did not engage")
    want = _wire_step_launches(cfg, n_ranks, rounding_bits)
    per_step = [h["kernel_launches"] for h in hist]
    if per_step != [want] * steps or launches != {k: v * steps
                                                 for k, v in want.items()}:
        raise AssertionError(f"wire training: launches {per_step} a step, "
                             f"wanted {want}")
    keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g", "il_wire_grads",
            "fl_wire_grads", "il_wire_grads_min", "il_wire_grads_max",
            "fl_wire_grads_min", "fl_wire_grads_max", "E_wire", "R_wire")
    traj = [{k: h[k] for k in keys} for h in hist]
    say("wire_train", command="python -m repro_torch.launch.train " + " ".join(argv),
        params=out["params"], data_ranks=n_ranks, rounding_bits=rounding_bits,
        losses=losses,
        first_step_s=out["first_step_s"],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        tokens_per_s_after_first=out["tokens_per_s_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"], formats=traj,
        launches=launches, launches_per_step=want,
        k4_tma_launches=dps_quant.reduce_tma_launch_count,
        E_wire=out["E_wire"], R_wire=out["R_wire"])
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses, out


# ---------------------------------------------------------------------------
# ZeRO-1 and the overlapped bucketed wire
# ---------------------------------------------------------------------------

# The full-width ZeRO runs' losses after the first step, against the wire
# run's.  Step 1 is the same forward on the same parameters (equal bit for
# bit).  Later steps start from parameters that differ in some elements:
# the wire step's stochastic optimizer-input snap of its mean, which a ZeRO
# step with an fp32 params leg skips (as the reference's does), bumps a
# large on-grid value by one gradient grid step now and then (floor(k + u)
# in fp32 rounds up when k is large and u near 1), and the embedding's
# backward sums with atomics on the card.  Each moves a few weights by a
# grid step.  Measured on an H100: 1.03e-4 relative at worst over 3 steps,
# the two ZeRO runs (with and without the overlap) bit-equal to each other.
ZERO_LOSS_RTOL = 1e-3


def _same_stats(sk, sp, what):
    """QuantStats kernel vs plain: count/nonzero/overflow/max_abs exact,
    float sums to SUM_RTOL; returns the largest relative sum difference."""
    for f in ("count", "nonzero", "overflow", "max_abs"):
        if not torch.equal(getattr(sk, f), getattr(sp, f)):
            raise AssertionError(f"{what}: {f} differs from the plain version")
    rel = max(float(((getattr(sk, f) - getattr(sp, f)).abs()
                     / getattr(sp, f).abs().clamp(min=1e-30)).max())
              for f in ("abs_err_sum", "rel_err_sum", "abs_sum"))
    if rel > SUM_RTOL:
        raise AssertionError(f"{what}: float sums differ by {rel:.3g}")
    return rel


def _bit_equal(a, b, what):
    if a.shape != b.shape or not torch.equal(a.contiguous().view(torch.int32),
                                             b.contiguous().view(torch.int32)):
        raise AssertionError(f"{what}: kernel result differs from plain")


def zero_collectives():
    """The ZeRO halves and the bucketed all-reduce on the card, kernels vs
    plain versions, on the ragged 4-rank tree of ``wire_collectives``:
    scalar and per-leaf formats, nearest rounding and stochastic with
    Philox bits in the kernels and with a bits operand.  Results bit-equal,
    statistics exact and to SUM_RTOL; each owner's reduce-scatter shard
    bit-equal to its chunk of the monolithic all-reduce's mean; the
    bucketed all-reduce bit-equal to the monolithic one."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.fixed_point import FixedPointFormat
    from repro_torch.dist import (GroupAlignedPartitioner, StackedTransport,
                                  ZeroPartitioner, bucketed_allreduce_mean_tree,
                                  dps_allgather_params, dps_allreduce_mean_tree,
                                  dps_reduce_scatter_mean, psum_stats,
                                  zero_allgather_params,
                                  zero_bucketed_reduce_scatter)
    rng = np.random.default_rng(4)
    n = 4
    trees = _ragged_tree(rng, n)
    G = len(tree_lib.leaves(trees[0]))
    fmts = {"scalar": FixedPointFormat.create(2, 6, DEV),
            "per_leaf": FixedPointFormat(
                torch.tensor([2, 1, 3, 2, 1, 2][:G], dtype=torch.int32, device=DEV),
                torch.tensor([6, 7, 5, 6, 7, 6][:G], dtype=torch.int32, device=DEV))}
    tr = StackedTransport(n, DEV)
    parts = {"one_bucket": GroupAlignedPartitioner.create(trees[0], n),
             "bucket_per_leaf": GroupAlignedPartitioner.create(
                 trees[0], n, buckets=[(g,) for g in range(G)])}
    plain = ZeroPartitioner.create(trees[0], n)
    backends = ("kernel", "plain")
    compared = {}
    for mode, onchip in (("nearest", True), ("stochastic", True),
                         ("stochastic", False)):
        kw = dict(mode=mode, onchip_prng=onchip)
        src = "" if mode == "nearest" else ("/philox" if onchip else "/operand")
        for name, fmt in fmts.items():
            what = f"{name}/{mode}{src}"
            rels = []
            mean, _ = dps_allreduce_mean_tree(trees, fmt, tr, 1234,
                                              backend="kernel", **kw)
            bk = {be: bucketed_allreduce_mean_tree(
                trees, fmt, tr, 1234, backend=be, target_elems=5000, **kw)
                for be in backends}
            for a, b, m in zip(tree_lib.leaves(bk["kernel"][0]),
                               tree_lib.leaves(bk["plain"][0]),
                               tree_lib.leaves(mean)):
                _bit_equal(a, b, f"bucketed all-reduce ({what})")
                _bit_equal(a, m, f"bucketed vs monolithic all-reduce ({what})")
            rels.append(_same_stats(psum_stats(bk["kernel"][1], tr),
                                    psum_stats(bk["plain"][1], tr),
                                    f"bucketed all-reduce ({what})"))
            for pname, part in parts.items():
                zs = {be: zero_bucketed_reduce_scatter(
                    trees, fmt, tr, 1234, part=part, backend=be, **kw)
                    for be in backends}
                _bit_equal(zs["kernel"][0], zs["plain"][0],
                           f"zero reduce-scatter ({what}, {pname})")
                rels.append(_same_stats(psum_stats(zs["kernel"][1], tr),
                                        psum_stats(zs["plain"][1], tr),
                                        f"zero reduce-scatter ({what})"))
                flat = part.flatten(mean)
                for j in range(n):
                    _bit_equal(zs["kernel"][0][j], part.shard(flat, j),
                               f"owner {j}'s shard vs its chunk of the mean "
                               f"({what}, {pname})")
                # the params leg: K3/K3b with statistics and the owner's
                # chunk of the mask, one launch per bucket per owner
                shards = list(zs["kernel"][0])
                ag = {be: zero_allgather_params(shards, fmt, tr, 77, part=part,
                                                backend=be, **kw)
                      for be in backends}
                _bit_equal(ag["kernel"][0], ag["plain"][0],
                           f"zero params all-gather ({what}, {pname})")
                rels.append(_same_stats(psum_stats(ag["kernel"][1], tr),
                                        psum_stats(ag["plain"][1], tr),
                                        f"zero params all-gather ({what})"))
            if name == "scalar":
                xs = [plain.flatten(t) for t in trees]
                rs = {be: dps_reduce_scatter_mean(xs, fmt, tr, 1234,
                                                  backend=be, **kw)
                      for be in backends}
                _bit_equal(rs["kernel"][0], rs["plain"][0],
                           f"dps_reduce_scatter_mean ({what})")
                rels.append(_same_stats(psum_stats(rs["kernel"][1], tr),
                                        psum_stats(rs["plain"][1], tr),
                                        f"dps_reduce_scatter_mean ({what})"))
                agp = {be: dps_allgather_params(list(rs["kernel"][0]), fmt, tr,
                                                77, backend=be, **kw)
                       for be in backends}
                _bit_equal(agp["kernel"][0], agp["plain"][0],
                           f"dps_allgather_params ({what})")
                rels.append(_same_stats(psum_stats(agp["kernel"][1], tr),
                                        psum_stats(agp["plain"][1], tr),
                                        f"dps_allgather_params ({what})"))
            compared[what] = {"bit_equal": True, "stats_sum_rel": max(rels)}
    torch.cuda.synchronize()
    say("zero_collectives", ranks=n, leaves=G, compared=compared,
        owner_shards_equal_allreduce_chunks=True,
        bucketed_equals_monolithic=True,
        buckets={k: p.n_buckets for k, p in parts.items()})


def zero_bucket_check(cfg, n=4):
    """The overlap path's largest bucket at full width, kernels vs plain: the
    w_in leaf's bucket of the partitioner ``launch.train --zero-opt
    --wire-overlap on`` builds (a bucket of its own, global leaf 7, so its
    bits are keyed by a nonzero group base).  Each of 4 ranks encodes its
    gradient into the bucket (K2b), then ``TreeAllReduce(layout=...)
    .scatter_snap`` runs K4 and the leg-2 snap (K3b) on every owner's
    [4, chunk] and ``decode_owned`` decodes each owner's chunk, as the train
    step does per bucket.  Leg-2 bytes, decoded shards and owner 1's K4
    mean bit-equal; leg-1 statistics exact and to SUM_RTOL.  Returns the K4
    and K3b rows at this shape (launches: every per-bucket launch of the
    overlap run)."""
    from repro_torch.core import qtrain
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.fixed_point import FixedPointFormat, fold_seed
    from repro_torch.dist import StackedTransport, TreeAllReduce, psum_stats
    from repro_torch.dist.collectives import (LEG2, _aligned_bits,
                                              _encode_aligned, _layout_tables,
                                              _wire_reduce)
    from repro_torch.models import transformer
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    paths = [p for p, _ in tree_lib.leaves_with_path(defs)]
    qcfg = dataclasses.replace(
        qtrain.QuantConfig(grad_allreduce_bits=8, wire_overlap=True)
        .with_per_layer_wire(defs), zero_opt_shards=n)
    part = qtrain.zero_partitioner(qcfg, defs, n)
    leaf = paths.index(("layers", "mlp", "w_in"))
    b = next(b for b in range(part.n_buckets)
             if part.leaf_range(b)[0] <= leaf < part.leaf_range(b)[1])
    lo, hi = part.leaf_range(b)
    lay = part.layouts[b]
    shapes = [tuple(d.shape) for d in tree_lib.leaves(defs)[lo:hi]]
    rng = np.random.default_rng(15)
    il = rng.integers(1, 3, len(paths))        # the wire settles at <1, 7>
    fmt = FixedPointFormat(torch.tensor(il[lo:hi], dtype=torch.int32, device=DEV),
                           torch.tensor(8 - il[lo:hi], dtype=torch.int32,
                                        device=DEV))
    tr = StackedTransport(n, DEV)
    seed = 1234

    def grad(r, g):
        gen = torch.Generator(device=DEV).manual_seed(100 * r + g)
        x = torch.randn(shapes[g], generator=gen, device=DEV) * 0.02
        x.view(-1)[::11] = 0.0
        return x

    like = [torch.empty((), device=DEV).expand(s) for s in shapes]
    runs, received = {}, None
    for be in ("kernel", "plain"):
        tw = TreeAllReduce(like, fmt, tr, seed, backend=be, group_base=lo,
                           layout=lay)
        for r in range(n):
            for g in range(hi - lo):
                tw.encode_leaf(r, g, grad(r, g))
        if be == "kernel":
            received = tr.all_to_all(tw.payload)     # kept for the timing
        stats = psum_stats(tw.stats, tr)
        wire2 = tw.scatter_snap()
        dec = [tw.decode_owned(i) for i in range(n)]
        runs[be] = (stats, wire2, dec)
        del tw
    torch.cuda.synchronize()
    (sk, wk, dk), (sp, wp, dp) = runs["kernel"], runs["plain"]
    rel = _same_stats(sk, sp, "w_in bucket leg 1")
    if not torch.equal(wk, wp):
        raise AssertionError("w_in bucket leg 2: kernel bytes differ from plain")
    k3b_err = _byte_err(wk, wp)
    for i in range(n):
        _bit_equal(dk[i], dp[i], f"w_in bucket, owner {i}'s decoded shard")
    del runs, wk, wp, dk, dp
    gc.collect()
    torch.cuda.empty_cache()

    # K4 and K3b on owner 1's [4, chunk] view, as _owner_rs_snap calls them
    c, q, j = lay.chunk, lay.quantum, 1
    tpc = c // q
    tg_all, goff = _layout_tables(lay, str(DEV))
    tg1 = tg_all[j * tpc:(j + 1) * tpc]
    view = received[j]
    if _reduce_body(view, q) != "tma":
        raise AssertionError("w_in bucket: K4 planned off the TMA body")
    tma0 = dps_quant.reduce_tma_launch_count
    mk = _wire_reduce(view, fmt, tg1, backend="kernel", quantum=q)
    if dps_quant.reduce_tma_launch_count != tma0 + 1:
        raise AssertionError("w_in bucket: K4 did not take the TMA body")
    mp = _wire_reduce(view, fmt, tg1, backend="plain", quantum=q)
    _bit_equal(mk, mp, "w_in bucket, owner 1's K4 mean")
    k4_err = float((mk - mp).abs().max())
    del mp
    red_ms = time_ms(lambda: _wire_reduce(view, fmt, tg1, backend="kernel",
                                          quantum=q), repeats=10)
    red_plain = time_ms(lambda: _wire_reduce(view, fmt, tg1, backend="plain",
                                             quantum=q), repeats=3, warmup=1)
    red_sum = torch_sum_ms(view)
    bits = _aligned_bits(fold_seed(seed, LEG2), lay, goff, j * c, c,
                         onchip_prng=True, group_base=lo)
    out = torch.empty(c, dtype=torch.int8, device=DEV)
    enc = lambda be: _encode_aligned(mk, fmt, tg1, None, bits=bits,
                                     mode="stochastic", backend=be, quantum=q,
                                     compute_stats=False,
                                     out=out if be == "kernel" else None)
    g3_ms = time_ms(lambda: enc("kernel"), repeats=10)
    g3_plain = time_ms(lambda: enc("plain"), repeats=2, warmup=1)
    G = hi - lo
    red_bytes = n * c + 4 * c + 4 * tpc + 8 * G
    g3_bytes = 4 * c + c + 4 * tpc + 8 * G + 8 * G
    del received, view, mk, out
    gc.collect()
    torch.cuda.empty_cache()
    shape = (f"the w_in bucket of the overlap run (bucket {b}, leaf {lo}, "
             f"{n} owners x chunk {c}, quantum {q})")
    note = ("launches: every per-bucket launch of the --zero-opt --wire-overlap "
            f"on run, {part.n_buckets} buckets x {n} owners a step; the other "
            "buckets' chunks are smaller")
    b4, by4 = bound(red_bytes, (2 * n + 1) * c)
    b3, by3 = bound(g3_bytes, 37 * c)
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
              "run": "zero_overlap", "launches_note": note, "library_ms": None}
    rows = [
        {"name": "dps_wire_reduce_zero_bucket", "counter": "dps_wire_reduce",
         "replaces": "src/repro/kernels/dps_quant.py:544",
         "shape": f"[{n}, {c}] int8 (owner {j}'s strided view) -> fp32 [{c}], "
                  f"{shape}", "max_abs_err": k4_err, "ms": red_ms,
         "plain_ms": red_plain, "bound_ms": b4, "bound_by": by4,
         "bytes": red_bytes, "body": "tma", "torch_sum_ms": red_sum,
         "torch_sum_note": TORCH_SUM_NOTE, **common},
        {"name": "dps_group_wire_encode_onchip_prng_zero_bucket",
         "counter": "dps_group_wire_encode_onchip_prng",
         "replaces": "src/repro/kernels/dps_quant.py:482",
         "shape": f"owner {j}'s mean chunk of {c} fp32 -> int8, Philox keyed "
                  f"by global group {lo}, no statistics (leg 2), {shape}",
         "max_abs_err": k3b_err, "ms": g3_ms, "plain_ms": g3_plain,
         "bound_ms": b3, "bound_by": by3, "bytes": g3_bytes, **common}]
    say("zero_bucket", bucket=b, group_base=lo, leaf="/".join(paths[leaf]),
        owners=n, chunk=c, quantum=q, leg2_bit_equal=True,
        decoded_shards_bit_equal=True, k4_mean_bit_equal=True,
        leg1_stats_sum_rel=rel, tolerance_sums=SUM_RTOL,
        rows=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms")}
              for r in rows])
    return rows


def k4_buckets(cfg, n=4):
    """K4 at every bucket of the overlap run (``launch.train --zero-opt
    --wire-overlap on``: the partitioner's 11 bucket layouts): owner 1's
    [4, chunk] strided view of a random [4, 4 chunk] stack, the bucket's
    tile map and a table of its leaves' formats; kernel vs plain bit-equal
    on the TMA body, the time replayed from a CUDA graph beside the bound.
    Returns the rows and the sum over buckets x owners (K4 a step)."""
    from repro_torch.core import qtrain
    from repro_torch.models import transformer
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    qcfg = dataclasses.replace(
        qtrain.QuantConfig(grad_allreduce_bits=8, wire_overlap=True)
        .with_per_layer_wire(defs), zero_opt_shards=n)
    part = qtrain.zero_partitioner(qcfg, defs, n)
    g = torch.Generator(device=DEV).manual_seed(16)
    rows = []
    for b in range(part.n_buckets):
        lo, hi = part.leaf_range(b)
        lay = part.layouts[b]
        c, q = lay.chunk, lay.quantum
        tpc = c // q
        tg = torch.from_numpy(lay.tile_groups()[tpc:2 * tpc]).to(DEV)
        G = hi - lo
        il = torch.randint(1, 3, (G,), device=DEV, generator=g)
        tab = torch.stack([il, 8 - il], 1).to(torch.int32).contiguous()
        stack = torch.randint(-128, 128, (n, n * c), dtype=torch.int8,
                              device=DEV, generator=g)
        view = stack.view(n, n, c).transpose(0, 1)[1]
        err = check_reduce(view, tab, tg, q, body="tma")
        ms = time_graph_ms(lambda: dps_quant.dps_wire_reduce(
            view, tab, tg, quantum=q, backend="kernel"),
            100 if c < 1 << 24 else 20)
        nbytes = n * c + 4 * c + 4 * tpc + 8 * G
        bnd, by = bound(nbytes, (2 * n + 1) * c)
        rows.append({"bucket": b, "leaves": [lo, hi], "chunk": c,
                     "ms": ms, "bound_ms": bnd, "bound_by": by,
                     "share_of_bound": bnd / ms, "max_abs_err": err})
        del stack, view
        torch.cuda.empty_cache()
    step_ms = n * sum(r["ms"] for r in rows)
    say("k4_buckets", owners=n, buckets=rows, k4_ms_a_step=step_ms,
        k4_bound_ms_a_step=n * sum(r["bound_ms"] for r in rows),
        timing="CUDA-graph replay, L2 flushed before each",
        tolerance="bit-equal")
    return rows, step_ms


def lenet_zero(steps=3):
    """LeNet over 4 stacked ranks with ZeRO-1, per-layer wire formats and
    every leaf quantized, so the parameter all-gather rides the int8 wire
    (K3 with statistics and a mask on each owner's chunk): kernel vs plain
    under nearest rounding, formats equal step by step, loss to
    LENET_LOSS_RTOL.  Returns the kernel run's launches."""
    from repro_torch.apps import mnist as app
    from repro_torch.core import qtrain
    from repro_torch.data import MNISTLike
    from repro_torch.dist import StackedTransport
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lenet as lenet_mod
    from repro_torch.optim import SGDConfig, make_optimizer
    data = MNISTLike(batch=64, seed=0, n_train=2048, n_test=512)
    keys = ("loss", "il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g",
            "il_wire_grads", "fl_wire_grads", "il_wire_params",
            "fl_wire_params", "E_wire", "R_wire")
    runs, launches = {}, None
    for backend in ("kernel", "plain"):
        with app._full_fp32(DEV):
            params = lenet_mod.init(0, DEV)
            q = dataclasses.replace(
                app.paper_quant_config(rounding="nearest"), onchip_prng=False,
                backend=backend, grad_allreduce_bits=8,
                zero_opt_shards=4).with_per_layer_wire(params)
            opt = make_optimizer(SGDConfig())
            tr = StackedTransport(4, DEV)
            step = qtrain.make_train_step(lenet_mod.loss_fn, opt, q,
                                          transport=tr)
            if not (step.zero_opt_active and step.zero_groupaligned_active
                    and qtrain.wire_params_engaged(q, params, tr)):
                raise AssertionError("LeNet ZeRO: the int8 params leg did not "
                                     "engage")
            state = qtrain.TrainState.create(
                params, qtrain.zero_opt_state(opt, params, tr, q), q, 1, DEV)
            hist = {k: [] for k in keys}
            train_cli.reset_launch_counts()
            for i in range(steps):
                b = {k: torch.from_numpy(v).to(DEV)
                     for k, v in data.train_batch(i).items()}
                state, m = step(state, b)
                for k in keys:
                    hist[k].append(float(m[k]))
            torch.cuda.synchronize()
            if backend == "kernel":
                launches = train_cli.launch_counts()
            runs[backend] = hist
    for k in keys[1:-2]:
        if runs["kernel"][k] != runs["plain"][k]:
            raise AssertionError(f"LeNet ZeRO kernel vs plain: {k} "
                                 f"{runs['kernel'][k]} vs {runs['plain'][k]}")
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                   zip(runs["kernel"]["loss"], runs["plain"]["loss"]))
    if loss_rel > LENET_LOSS_RTOL:
        raise AssertionError(f"LeNet ZeRO kernel vs plain: loss differs by "
                             f"{loss_rel:.3g} relative")
    # per step: K1 8 weights + 8 re-snaps + 4 ranks x (4 taps forward and
    # backward, the logit gradient, 8 raw-gradient leaves) + the flat
    # optimizer-input snap of 4 owners; K2 4 x 8 leaves; K4 4 owners; K3 4
    # leg-2 chunks + 4 params-leg chunks (one bucket)
    want = {k: 0 for k in launches}
    want.update({"dps_quantize": 88 * steps, "dps_quant_wire": 32 * steps,
                 "dps_wire_reduce": 4 * steps,
                 "dps_group_wire_encode": 8 * steps})
    if launches != want:
        raise AssertionError(f"LeNet ZeRO: launches {launches}, wanted {want}")
    say("lenet_zero", steps=steps, ranks=4, launches=launches,
        kernel=runs["kernel"], loss_max_rel_vs_plain=loss_rel,
        tolerance=LENET_LOSS_RTOL, formats_equal=True)
    return launches


def train_zero(cfg, wire_first_loss, overlap, steps=4, n_ranks=4):
    """``launch.train --zero-opt [--wire-overlap on]`` at full size: 4
    ranks on the card, per-layer wire formats, SGD; ZeRO (and the overlap)
    engaged, finite losses, the first equal to the wire run's, launches a
    step as the CPU rehearsal counts them."""
    from repro_torch.dist import plan_buckets
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer
    from repro_torch.core import tree as tree_lib
    argv = ["--arch", "llama3_2_3b", "--steps", str(steps), "--batch",
            str(n_ranks), "--seq", "512", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", str(n_ranks),
            "--zero-opt", "--log-every", "1"]
    if overlap:
        argv += ["--wire-overlap", "on"]
    train_cli.reset_launch_counts()            # the counted run
    dps_quant.reduce_tma_launch_count = 0
    out = train_cli.main(argv)
    launches = train_cli.launch_counts()
    _all_k4_on_tma(launches, "ZeRO training")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ZeRO training: losses {losses}")
    if not (out["zero_opt"] and out["zero_groupaligned"]
            and out["wire_overlap"] == overlap):
        raise AssertionError(f"ZeRO training: zero_opt {out['zero_opt']}, "
                             f"wire_overlap {out['wire_overlap']}")
    if losses[0] != wire_first_loss:
        raise AssertionError(f"ZeRO training: step-1 loss {losses[0]!r} is "
                             f"not the wire run's {wire_first_loss!r}")
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    buckets = (plan_buckets([math.prod(d.shape) for d in
                             tree_lib.leaves(defs)]).n_buckets
               if overlap else 1)
    if out["wire_buckets"] != buckets:
        raise AssertionError(f"ZeRO training: {out['wire_buckets']} buckets, "
                             f"wanted {buckets}")
    want = _wire_step_launches(cfg, n_ranks, "onchip", zero_buckets=buckets)
    per_step = [h["kernel_launches"] for h in hist]
    if per_step != [want] * steps or launches != {k: v * steps
                                                 for k, v in want.items()}:
        raise AssertionError(f"ZeRO training: launches {per_step} a step, "
                             f"wanted {want}")
    say("zero_train", command="python -m repro_torch.launch.train " + " ".join(argv),
        params=out["params"], data_ranks=n_ranks, overlap=overlap,
        buckets=buckets, losses=losses,
        wire_run_losses_first=wire_first_loss,
        first_step_s=out["first_step_s"],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        tokens_per_s_after_first=out["tokens_per_s_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"], launches=launches,
        launches_per_step=want,
        k4_tma_launches=dps_quant.reduce_tma_launch_count,
        E_wire=out["E_wire"], R_wire=out["R_wire"],
        formats=[{k: h[k] for k in ("il_w", "fl_w", "il_g", "fl_g",
                                    "il_wire_grads", "fl_wire_grads")}
                 for h in hist])
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches, hist


# ---------------------------------------------------------------------------
# Checkpoint and resume, the health guards and the fault drills
# ---------------------------------------------------------------------------

# the launch counters of the int8 wire's kernels: 0 on a degraded step
WIRE_KERNELS = ("dps_quant_wire_onchip_prng", "dps_wire_reduce",
                "dps_group_wire_encode_onchip_prng")


def ckpt_space(cfg):
    """A fresh directory under ``build/`` (git-ignored) for the full-width
    checkpoints, after checking that its disk holds two SGD wire states at
    once (fp32 parameters and momenta, 8 bytes a parameter): run A's arrays
    are deleted once its manifest is read, so at most run B's step 2 and
    run B′'s step 4 exist together.  Returns ``(dir, free bytes)``."""
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    free = shutil.disk_usage(base).free
    need = 2 * 8 * cfg.n_params() + (2 << 30)
    if free < need:
        raise AssertionError(f"ckpt_resume: {free} bytes free under {base}, "
                             f"the phase needs {need}")
    return tempfile.mkdtemp(prefix="ckpt_", dir=base), free


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _rate(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds else None


def ckpt_resume(root, free, run_a):
    """Run A (the counted wire run, its checkpoint at step 4 in
    ``root/a``), run B (the same with ``--sigterm-at 2``: a real SIGTERM,
    ``PREEMPTED``, a checkpoint at step 2) and run B′ (``--resume`` to step
    4): B′'s steps 2-3 bit-equal to A's in every metric, and its step-4
    manifest's digests equal to A's for every key — the whole state."""
    from repro_torch.launch import train as train_cli
    a_dir, b_dir = os.path.join(root, "a"), os.path.join(root, "b")
    step_a = os.path.join(a_dir, "step_00000004")
    ma = _manifest(a_dir, 4)
    disk = sum(os.path.getsize(os.path.join(step_a, f))
               for f in os.listdir(step_a))
    # A's digests are all the comparison needs: its arrays make room
    os.remove(os.path.join(step_a, "arrays.npz"))
    t0 = time.perf_counter()
    b = train_cli.main(wire_argv(4, 4, "onchip", "--ckpt-dir", b_dir,
                                 "--sigterm-at", "2"))
    b_s = time.perf_counter() - t0
    if b.get("preempted_at") != 2 or os.listdir(b_dir) != ["step_00000002"]:
        raise AssertionError(f"ckpt_resume: run B was not preempted at step "
                             f"2 ({b.get('preempted_at')}, {os.listdir(b_dir)})")
    hist_a = run_a["history"]
    if b["history"] != hist_a[:2]:
        raise AssertionError("ckpt_resume: run B's steps 0-1 differ from A's")
    t0 = time.perf_counter()
    b2 = train_cli.main(wire_argv(4, 4, "onchip", "--ckpt-dir", b_dir,
                                  "--resume"))
    b2_s = time.perf_counter() - t0
    res = b2["resumed"]
    if res is None or res.get("step") != 2:
        raise AssertionError(f"ckpt_resume: run B′ resumed from {res}")
    if b2["history"] != hist_a[2:]:
        diff = sorted({k for x, y in zip(b2["history"], hist_a[2:])
                       for k in x if x[k] != y.get(k)})
        raise AssertionError(f"ckpt_resume: the resumed steps 2-3 differ "
                             f"from run A's in {diff}")
    mb = _manifest(b_dir, 4)
    if mb["digests"] != ma["digests"]:
        diff = sorted(k for k in ma["digests"]
                      if mb["digests"].get(k) != ma["digests"][k])
        raise AssertionError(f"ckpt_resume: step-4 digests differ in {diff}")
    saves = {"a": run_a["ckpt_saves"][-1], "b": b["ckpt_saves"][-1],
             "b_resumed": b2["ckpt_saves"][-1]}
    nbytes = saves["a"]["bytes"]
    say("ckpt_resume",
        command=("python -m repro_torch.launch.train "
                 + " ".join(wire_argv(4, 4, "onchip", "--ckpt-dir", "D",
                                      "[--sigterm-at 2 | --resume]"))),
        free_bytes_before=free, bytes_on_disk=disk, state_bytes=nbytes,
        arrays=len(ma["digests"]),
        saves={k: dict(v, stall_GBps=_rate(v["bytes"], v["stall_s"]),
                       write_GBps=_rate(v["bytes"], v.get("write_s")))
               for k, v in saves.items()},
        verify_s=res["verify_s"],
        verify_GBps=_rate(nbytes, res["verify_s"]),
        restore_s=res["restore_s"],
        restore_GBps=_rate(nbytes, res["restore_s"]),
        metrics_bit_equal=sorted(hist_a[2]), steps_compared=[2, 3],
        digests_equal=True,
        ms_per_step_after_first={"a": run_a["ms_per_step_after_first"],
                                 "b_resumed": b2["ms_per_step_after_first"]},
        seconds={"a": run_a["seconds"], "b": b_s, "b_resumed": b2_s})
    gc.collect()
    torch.cuda.empty_cache()


def _smoke_argv(steps, *extra):
    """``launch.train`` on the card at smoke size (the int8 wire, 2
    ranks)."""
    return ["--arch", "llama3_2_3b", "--smoke", "--steps", str(steps),
            "--batch", "4", "--seq", "16", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", "2",
            "--log-every", "1", *extra]


def ckpt_corrupt():
    """At smoke size on the card: a bit flip and a truncation of the newest
    checkpoint are walked past by ``latest_step`` and refused by
    ``restore``, and ``--resume`` lands on the good step; then a ZeRO-1
    run preempted at step 2 and resumed equals its uninterrupted run bit
    for bit (every metric, every digest)."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.launch import train as train_cli
    from repro_torch.resilience import corrupt_checkpoint
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        modes = {}
        for mode in ("bitflip", "truncate"):
            d = os.path.join(root, mode)
            train_cli.main(_smoke_argv(4, "--ckpt-dir", d, "--ckpt-every",
                                       "2"))
            corrupt_checkpoint(d, 4, mode)
            if latest_step(d) != 2:
                raise AssertionError(f"ckpt_corrupt ({mode}): latest_step "
                                     f"{latest_step(d)}, wanted 2")
            template = train_cli.setup(train_cli.make_parser().parse_args(
                _smoke_argv(4)))[2]
            try:
                restore(d, 4, template)
            except Exception as e:          # noqa: BLE001 — the refusal
                refused = f"{type(e).__name__}: {e}"[:200]
            else:
                raise AssertionError(f"ckpt_corrupt ({mode}): step 4 restored")
            del template
            out = train_cli.main(_smoke_argv(6, "--ckpt-dir", d, "--resume"))
            if (out["resumed"] or {}).get("step") != 2 or len(
                    out["history"]) != 4:
                raise AssertionError(f"ckpt_corrupt ({mode}): resumed "
                                     f"{out['resumed']}")
            modes[mode] = refused
        zero = ["--zero-opt"]
        a = train_cli.main(_smoke_argv(4, "--ckpt-dir",
                                       os.path.join(root, "za"), *zero))
        b = train_cli.main(_smoke_argv(4, "--ckpt-dir",
                                       os.path.join(root, "zb"),
                                       "--sigterm-at", "2", *zero))
        b2 = train_cli.main(_smoke_argv(4, "--ckpt-dir",
                                        os.path.join(root, "zb"),
                                        "--resume", *zero))
        if not (a["zero_opt"] and b.get("preempted_at") == 2
                and b2["resumed"]["step"] == 2
                and b["history"] + b2["history"] == a["history"]
                and _manifest(os.path.join(root, "za"), 4)["digests"]
                == _manifest(os.path.join(root, "zb"), 4)["digests"]):
            raise AssertionError("ckpt_corrupt: the resumed ZeRO run differs "
                                 "from the uninterrupted one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("ckpt_corrupt", refused=modes, latest_step_walked_back_to=2,
        resumed_from=2, zero_resume_bit_equal=True,
        seconds=time.perf_counter() - t0)


def _fingerprint(state):
    """Exact fingerprints of the parameters, optimizer state and DPS state,
    taken on the device: ``{checkpoint key: (int64 sum of the leaf's 32-bit
    patterns, their max)}``."""
    from repro_torch.checkpoint.ckpt import _walk
    rows = {}

    def take(key, t):
        if t.element_size() != 4:
            raise AssertionError(f"fingerprint: {key} is {t.dtype}")
        bits = t.detach().contiguous().view(torch.int32)
        rows[key] = torch.stack([bits.sum(dtype=torch.int64),
                                 bits.max().to(torch.int64)])
    for name in ("params", "opt_state", "dps"):
        _walk(getattr(state, name), "." + name, take)
    keys = sorted(rows)
    return dict(zip(keys, torch.stack([rows[k] for k in keys]).cpu()
                    .tolist()))


def _metrics(hist):
    return [{k: v for k, v in h.items()
             if k not in ("health", "skipped", "trips", "degraded")}
            for h in hist]


def guards_idle(cfg, run_a):
    """The full-width wire run with ``--guards`` and no fault, 4 steps:
    every metric run A reports bit-equal, health 0 on every step; its step
    time and peak memory beside A's."""
    from repro_torch.launch import train as train_cli
    argv = wire_argv(4, 4, "onchip", "--guards")
    t0 = time.perf_counter()
    train_cli.reset_launch_counts()
    out = train_cli.main(argv)
    hist = out["history"]
    if _metrics(hist) != run_a["history"]:
        diff = sorted({k for x, y in zip(_metrics(hist), run_a["history"])
                       for k in x if x[k] != y.get(k)})
        raise AssertionError(f"guards_idle: armed idle guards moved {diff}")
    if any(h["health"] or h["skipped"] or h["degraded"] for h in hist):
        raise AssertionError(f"guards_idle: health {[h['health'] for h in hist]}")
    say("guards_idle", command="python -m repro_torch.launch.train "
        + " ".join(argv), metrics_bit_equal_to_run_a=sorted(run_a["history"][0]),
        health=[h["health"] for h in hist],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        run_a_ms_per_step_after_first=run_a["ms_per_step_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"],
        run_a_peak_memory_bytes=run_a["peak_memory_bytes"],
        launches=train_cli.launch_counts(), seconds=time.perf_counter() - t0)
    del out
    gc.collect()
    torch.cuda.empty_cache()


def guards_nan(cfg, run_a):
    """The full-width wire run with ``--guards --inject-nan-at 1
    --guard-cooldown 1``, 4 steps: step 1 flags its NaN gradients and is
    skipped with the parameters, momenta and DPS state held exactly (device
    fingerprints before and after it); step 2 runs the fp32 fallback (no
    K2b, K4 or K3b launch); step 3 is back on the int8 wire with run A's
    launches; every loss after step 1 finite."""
    from repro_torch.launch import train as train_cli
    from repro_torch.resilience import (HEALTH_DEGRADED,
                                        HEALTH_GRADS_NONFINITE,
                                        HEALTH_SKIPPED, health_flags)
    argv = wire_argv(4, 4, "onchip", "--guards", "--inject-nan-at", "1",
                     "--guard-cooldown", "1")
    prints = {}

    def on_step(step, state):
        if step in (0, 1):
            prints[step] = _fingerprint(state)

    t0 = time.perf_counter()
    train_cli.reset_launch_counts()
    out = train_cli.main(argv, on_step=on_step)
    hist = out["history"]
    want = run_a["history"][0]["kernel_launches"]
    h1 = int(hist[1]["health"])
    need = HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED | HEALTH_DEGRADED
    if h1 & need != need:
        raise AssertionError(f"guards_nan: step 1 health {health_flags(h1)}")
    # held exactly, but for the trip's one extra IL bit on the compute
    # gradients (widen_on_trip, as the reference does)
    widened = ".dps/grads/.il"
    moved = sorted(k for k in prints[0]
                   if k != widened and prints[0][k] != prints[1][k])
    if moved or prints[1][widened] != [v + 1 for v in prints[0][widened]]:
        raise AssertionError(f"guards_nan: the skipped step moved {moved} "
                             f"({widened} {prints[0][widened]} -> "
                             f"{prints[1][widened]})")
    deg = hist[2]["kernel_launches"]
    if (any(deg[k] for k in WIRE_KERNELS)
            or {k: v for k, v in deg.items() if k not in WIRE_KERNELS}
            != {k: v for k, v in want.items() if k not in WIRE_KERNELS}):
        raise AssertionError(f"guards_nan: the degraded step launched {deg}")
    if hist[3]["kernel_launches"] != want or hist[3]["health"]:
        raise AssertionError(f"guards_nan: step 3 launched "
                             f"{hist[3]['kernel_launches']} (health "
                             f"{hist[3]['health']})")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses[2:]):
        raise AssertionError(f"guards_nan: losses {losses}")
    say("guards_nan", command="python -m repro_torch.launch.train "
        + " ".join(argv), losses=losses,
        health=[list(health_flags(int(h["health"]))) for h in hist],
        skipped=[h["skipped"] for h in hist],
        degraded=[h["degraded"] for h in hist],
        state_held_on_skip=True, fingerprinted_leaves=len(prints[0]),
        widened_grads_il=[prints[0][widened][0], prints[1][widened][0]],
        launches_per_step=[h["kernel_launches"] for h in hist],
        E_wire=[h["E_wire"] for h in hist],
        peak_memory_bytes=out["peak_memory_bytes"],
        seconds=time.perf_counter() - t0)
    del out
    gc.collect()
    torch.cuda.empty_cache()


def rollback():
    """At smoke size on the card, the reference test's drill: NaN gradients
    at step 5 without guards, a ring of 2; 1-8 rollbacks, each replayed
    window's step-5 loss finite again, and the run completes."""
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    out = train_cli.main(["--arch", "llama3_2_3b", "--smoke", "--steps", "10",
                          "--batch", "2", "--seq", "16", "--optimizer", "sgd",
                          "--inject-nan-at", "5", "--rollback-ring", "2",
                          "--log-every", "2"])
    n_rb = out["rollbacks"]
    losses = [h["loss"] for h in out["history"]]
    first_bad = next((i for i, v in enumerate(losses)
                      if not math.isfinite(v)), None)
    if (not 1 <= n_rb <= 8 or first_bad is None
            or sum(math.isfinite(v) for v in losses[first_bad:]) < n_rb):
        raise AssertionError(f"rollback: {n_rb} rollbacks, losses {losses}")
    say("rollback", rollbacks=n_rb, drained_steps=len(losses),
        finite_after_first_bad=sum(math.isfinite(v)
                                   for v in losses[first_bad:]),
        seconds=time.perf_counter() - t0)


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
    rows += quant_checks(cfg)
    rows += wire_kernel_checks(cfg)
    # each path runs with the counts set to 0 just before it, read just after
    launches = serve(cfg, lay)
    gc.collect()
    torch.cuda.empty_cache()                   # the serving engine's memory
    lenet_k1 = lenet()["dps_quantize"]
    launches["dps_quantize_onchip_prng"] = train_lm(
        cfg, "onchip", 4)["dps_quantize_onchip_prng"]
    launches["dps_quantize"] = train_lm(cfg, "operand", 3)["dps_quantize"]
    wire_collectives()
    # run A of the checkpoint phase is the counted wire run
    ckpt_root, free = ckpt_space(cfg)
    try:
        t0 = time.perf_counter()
        wire, wire_losses, run_a = train_wire(
            cfg, ckpt_dir=os.path.join(ckpt_root, "a"))
        run_a["seconds"] = time.perf_counter() - t0
        for k in ("dps_quant_wire_onchip_prng",
                  "dps_group_wire_encode_onchip_prng", "dps_wire_reduce"):
            launches[k] = wire[k]
        ckpt_resume(ckpt_root, free, run_a)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt_corrupt()
    guards_idle(cfg, run_a)
    guards_nan(cfg, run_a)
    rollback()
    del run_a
    launches["dps_quant_wire"] = train_wire(
        cfg, steps=2, rounding_bits="operand")[0]["dps_quant_wire"]
    # ZeRO-1 and the overlapped wire: the halves on the card, LeNet's int8
    # params leg, then the trainer at full width without and with the
    # overlap; each run counted from 0
    zero_collectives()
    rows += zero_bucket_check(cfg)
    bucket_rows, k4_step_ms = k4_buckets(cfg)
    for r in rows:
        if r["name"] == "dps_wire_reduce_zero_bucket":
            r["k4_buckets"] = [{k: b[k] for k in ("bucket", "chunk", "ms",
                                                  "bound_ms")}
                               for b in bucket_rows]
            r["k4_ms_a_step_overlap"] = k4_step_ms
    zero_launches = {"lenet_zero": lenet_zero()}
    zero_hist = {}
    for run, overlap in (("zero", False), ("zero_overlap", True)):
        zero_launches[run], zero_hist[run] = train_zero(
            cfg, wire_losses[0], overlap)
    zero_losses = {run: [h["loss"] for h in hist]
                   for run, hist in zero_hist.items()}
    rel = {run: max(abs(a - b) / abs(b) for a, b in
                    zip(ls[1:], wire_losses[1:]))
           for run, ls in zero_losses.items()}
    if max(rel.values()) > ZERO_LOSS_RTOL:
        raise AssertionError(f"ZeRO training: losses after the first differ "
                             f"from the wire run's by {rel} relative "
                             f"(> {ZERO_LOSS_RTOL})")
    # the overlap changes when and in what pieces the wire runs, not what it
    # computes: every metric of every step (losses, every domain's formats,
    # E/R, E_wire/R_wire) bit-equal to the run without it
    metrics = [{k: v for k, v in h.items()
                if k not in ("launches", "kernel_launches")}
               for h in zero_hist["zero"]]
    over = [{k: v for k, v in h.items()
             if k not in ("launches", "kernel_launches")}
            for h in zero_hist["zero_overlap"]]
    if metrics != over:
        diff = sorted({k for a, b in zip(metrics, over) for k in a
                       if a[k] != b.get(k)})
        raise AssertionError(f"ZeRO training: the overlap run differs from "
                             f"the run without it in {diff}")
    say("zero_vs_wire", wire_losses=wire_losses, zero_losses=zero_losses,
        loss_max_rel_after_first=rel, tolerance=ZERO_LOSS_RTOL,
        step1_bit_equal=True, overlap_bit_equal_metrics=sorted(metrics[0]))
    # a row measured at the overlap run's bucket shape takes that run's
    # launches; the rows of the same counters at other shapes do not
    at_bucket = {(r["run"], r["counter"]) for r in rows if "run" in r}
    for r in rows:
        if "run" in r:
            r["launches"] = zero_launches[r["run"]][r["counter"]]
        else:
            # a row off the path (K5 at a long context) has no launches
            r["launches"] = (launches[r["name"]] if r.get("on_path", True)
                             else 0)
        if r.get("on_path", True) and r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on the main path")
        if r["name"] == "dps_quantize":
            r["launches_lenet"] = lenet_k1
        for run, counts in zero_launches.items():
            if ("run" not in r and counts.get(r["name"])
                    and (run, r["name"]) not in at_bucket):
                r[f"launches_{run}"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
