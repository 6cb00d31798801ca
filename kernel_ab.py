"""Time the port's hand-written kernels of several source trees side by side
on one card.

    python3 kernel_ab.py [--out FILE]
                         [--only k5,quant,k4,host,split,bodies,k3]
                         [--clean-l2] TREE [TREE ...]

Each TREE is a checkout of this repository (a directory that holds
``src/repro_torch``), for example the parent commit unpacked with
``git archive`` into a git-ignored directory.  Give the trees as ``PARENT
CHANGE CHANGE PARENT`` to see how far two runs of one tree drift apart.  Each
tree is timed in a child process of its own, in the order given, its kernels
built from its own sources into ``build/kernel_ab/<n>``.  A child measures:

* paged decode attention (K5) at ``chip_smoke.py``'s serving shape (8 rows,
  24 query and 8 KV heads of 128 channels, 16-token int8 pages, lengths
  [577, 512, 300, 129, 64, 65, 1, 0]) and at a long context (8 rows of 4,096
  tokens), each timed two ways: replayed from a CUDA graph, and by direct
  calls between CUDA events (which also time the Python wrapper's host
  work); its largest difference from the tree's plain version at both
  shapes; and, for a tree whose K5 is split-KV, the graph-replayed time at
  splits of 32, 64 and 128 tokens, launched through the library's C entry so
  that the wrapper's split stays as it is;
* the quantizer: K1 (bits operand) and K1b (Philox bits) on leaves of
  400,000 values (LeNet's fc1), 9,437,184 (a 3072 x 3072 projection),
  25,165,824 (one layer of llama3.2-3b's w_in) and 704,643,072 (the whole
  w_in leaf), K2 (bits operand) and K2b (Philox) onto the int8 wire, and
  K1b in block mode on one rank's block of one w_in layer at (1, 4) and
  (2, 4) and on the 28-layer leaf's block at (1, 4), with statistics and
  without, each replayed from a CUDA graph;
* the wire's decode-and-mean K4 at four shapes of 4 int8 rows: owner 1's
  strided view of the full llama3.2-3b tree's [4, 4c] stack (c =
  803,385,344, per-layer formats), owner 1's view at the overlap run's w_in
  bucket (c = 176,160,768, one format), at that run's smallest bucket (the
  final norm: c = 3,072, quantum 3,072), and a contiguous [4, 176,160,768]
  stack as the process-group transport delivers it; each replayed from a
  CUDA graph and held bit-equal to the tree's plain version; and, for a tree
  whose K4 has a TMA body (``reduce_plan``), its time launched through the
  library's C entry at the wrapper's setting and at other spans, stage
  counts and grids;
* ``host`` (not in the default set): the quantizer's wrapper where a launch
  is short enough for its host work to show — K1b in block mode on one
  rank's block of one w_in layer at (1, 4) (3,072 x 2,048 of 8,192
  columns) with statistics and without, K1b on as many contiguous
  elements, and K1 on 4,096 — each timed between CUDA events as above and
  by the host's wall clock a call (the median of 5 loops of 500 calls,
  synchronized after each loop).

* ``split`` (not in the default set): K1b's block mode at those three
  blocks, and the contiguous launch on as many elements, timed between CUDA
  events around the wrapper, replayed from a graph, and replayed with the
  L2 flushed by a read, with statistics and without, and the device
  kernels a call with each one's device time (``torch.profiler``);
* ``bodies`` (not in the default set; a tree whose quantizer has a
  ``quant_plan``): K1b and K1 to nearest with statistics on the TMA body
  and on the grid-stride body at ``BODY_SIZES`` (400,000 to 704,643,072
  elements), and the body the plan takes;
* ``k3`` (not in the default set): the grouped wire encoder, K3 at each
  config's admission (``K3_ADMISSIONS``: one tile a page of one layer's K
  or V, each tile its own group, as ``chip_smoke.py``'s
  ``serve_shape_rows`` builds them), masked (the reference's call) and
  unmasked, without statistics; and K3b (Philox keyed per group) at
  owner 1's chunk of llama3.2-3b's and mamba2-1.3b's per-layer layouts
  over 4 ranks and at the overlap run's w_in bucket (group base 7), with
  statistics and without.  Each row is read three ways — between CUDA
  events around the wrapper (the L2 zero-filled), replayed from a CUDA
  graph (zero fill), replayed with the L2 flushed by a read — with the
  device kernels a call and each one's device microseconds
  (``torch.profiler``); each admission row's bytes and statistics are held
  to the tree's plain version.

Every time is the median over repeated launches with the 50 MB L2 cache
overwritten before each, as in ``chip_smoke.py``: by a zero fill, which
leaves dirty lines for the kernel's own traffic to write back, or with
``--clean-l2`` (the quant set; ``split`` and ``bodies`` read both or the
clean one) by a read of 256 MB.

Measured (``--only k4``, PARENT CHANGE CHANGE PARENT, on an H100 80GB HBM3 at
700.00 W), K4's grid-stride body against its TMA body, ms: 3.237 / 3.245
against 2.435 / 2.439 on the 803 M-element owner view; 0.710 / 0.707 against
0.496 / 0.568 on the w_in bucket; 0.0082 / 0.0083 against 0.0080 / 0.0079 on
the smallest bucket; 0.705 / 0.708 against 0.497 / 0.499 on the contiguous
stack.  Direct launches of the TMA body: 2.25-2.58 and 0.493-0.536 at every
stage setting.  Inputs are made from
seed 0, the same for every tree.  The output is the card's name and power
limit, then one JSON line a tree; ``--out`` also writes them to a file.
Needs one CUDA card; exits non-zero if a tree fails.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

ATTN_SHAPE = dict(B=8, H=24, KV=8, Dh=128, ps=16)
SERVE_LENS = [577, 512, 300, 129, 64, 65, 1, 0]
SERVE_P = 37                       # pages a row: chip_smoke.py's serving layout
LONG_TOKENS = 4096
QUANT_SIZES = {"lenet_fc1": 400_000, "proj": 3072 * 3072,
               "w_in_layer": 3072 * 8192, "w_in": 28 * 3072 * 8192}
# K4's shapes: (rows' chunk c, quantum, owner view of a [4, 4c] stack or
# contiguous rows)
K4_SHAPES = {"owner_803M": (803_385_344, 4096, True),
             "w_in_bucket": (176_160_768, 4096, True),
             "small_bucket": (3072, 3072, True),
             "contiguous": (176_160_768, 4096, False)}
# K4's TMA body launched directly: (span, stages, blocks an SM), the
# wrapper's own setting first
K4_VARIANTS = [(4096, 4, 2), (2048, 4, 2), (4096, 2, 2), (4096, 3, 2),
               (4096, 6, 2), (4096, 8, 1), (4096, 4, 3)]
# K3 at each config's admission: (tiles, quantum) = (2 * layers * 32 prompt
# pages, 16 * KV heads * head dim), the layers each config serves in
# chip_smoke.py
K3_ADMISSIONS = {"llama3_2_3b": (1792, 16384), "gemma_7b": (1792, 65536),
                 "mistral_large_123b": (512, 16384),
                 "nemotron_4_340b": (128, 24576),
                 "qwen3_moe_30b_a3b": (2048, 8192)}
# K3b on owner 1 of 4: (config whose per-layer layout is cut, chunk); the
# w_in bucket is the one leaf of 28 * 3072 * 8192 values, global group 7
K3B_CHUNKS = {"llama_owner": ("llama3_2_3b", 803_385_344),
              "w_in_bucket": (None, 176_160_768),
              "mamba2_owner": ("mamba2_1_3b", 336_146_432)}
# (kernel, leaf) pairs timed; each with statistics and without
QUANT_CASES = [("K1b", "lenet_fc1"), ("K1b", "proj"), ("K1b", "w_in"),
               ("K1", "lenet_fc1"), ("K1", "w_in_layer"),
               ("K2", "w_in"), ("K2b", "lenet_fc1"), ("K2b", "w_in")]
# K1b in block mode: (whole shape, the block's origin, its shape) of one
# rank's block of llama3.2-3b's w_in as place_tensor cuts it under the
# configs' specs — one layer at (1, 4) (columns 2,048-4,095 of 8,192) and at
# (2, 4) (rows 1,536-3,071 too), and the whole 28-layer leaf's block at
# (1, 4), the placed step's own launch on w_in
QUANT_BLOCKS = {"w_in_layer_1x4": ((3072, 8192), (0, 2048), (3072, 2048)),
                "w_in_layer_2x4": ((3072, 8192), (1536, 2048), (1536, 2048)),
                "w_in_1x4": ((28, 3072, 8192), (0, 0, 2048), (28, 3072, 2048))}


# ---------------------------------------------------------------------------
# timing (chip_smoke.py times its kernels with these too)
# ---------------------------------------------------------------------------

_flush = None


def _flush_l2(clean):
    """Overwrite the 50 MB L2 cache with 256 MB of other data: by default a
    zero fill, which leaves the cache full of dirty lines that the next
    kernel's own traffic must write back; ``clean``: a read of the same
    256 MB, which leaves clean lines."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    if clean:
        _flush.view(torch.int32).max()
    else:
        _flush.zero_()


def time_ms(fn, repeats, warmup=3, clean=False):
    """Median milliseconds of ``fn()`` by CUDA events, one pair per launch,
    the 50 MB L2 cache overwritten before each so the call finds it cold, as
    it does between two layers of the serving path (``clean``: overwritten
    by a read, see :func:`_flush_l2`)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(repeats):
        _flush_l2(clean)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def time_graph_ms(fn, repeats, warmup=3, clean=False):
    """Median milliseconds of ``fn()`` replayed from a CUDA graph, timed like
    :func:`time_ms`.  A replay costs the host a few microseconds, so a
    kernel that runs for tens of microseconds is not timed behind its Python
    wrapper's own overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    ms = time_ms(graph.replay, repeats, warmup=0, clean=clean)
    del graph
    return ms


def _device_us(evt):
    """Device time of a profiler entry that ran on the device (a kernel or
    a copy), 0 for a host-side entry."""
    if "cuda" not in str(getattr(evt, "device_type", "")).lower():
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _session(fn, calls):
    """One ``torch.profiler`` session of ``calls`` calls of ``fn``: the
    device events by name, (device microseconds, count)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0.0:
            by_name[e.key] = (us, e.count)
    return by_name


def device_kernels(fn, calls=20, tries=3, slack=2):
    """``fn()`` called outside any graph under ``torch.profiler``: the
    device kernels (and copies) a call launches, and each one's mean device
    microseconds, by name.  A name recorded ``k * calls`` times, give or
    take ``slack`` records, is launched ``k`` times a call: in
    ``chip_smoke.py``'s process on an H100 a session lost a record of the
    session's last calls or took one of the calls before it (9 or 11
    kernels for 10 one-kernel calls, in no fixed pattern from one session
    to the next), and after the plain paged attention at gemma-7b's
    geometry a session recorded nothing until the caching allocator's free
    blocks were released (they are, before each session).  A session where
    a name is further off is taken again, ``tries`` times at most; then the
    count a call is returned as recorded, not a whole number, and fails the
    callers' checks.  A session of fewer than ``calls - slack`` device
    events is taken again too (every caller's ``fn`` launches a kernel); if
    each one was, the reading raises: it would say nothing."""
    fn()
    torch.cuda.synchronize()
    read = None
    for _ in range(tries):
        by_name = _session(fn, calls)
        recorded = sum(c for _, c in by_name.values())
        if recorded < calls - slack:
            continue
        per_name = {k: round(c / calls) for k, (_, c) in by_name.items()}
        whole = all(abs(c - per_name[k] * calls) <= slack
                    for k, (_, c) in by_name.items())
        read = (sum(per_name.values()) if whole else recorded / calls,
                by_name)
        if whole:
            break
    if read is None:
        raise RuntimeError(f"torch.profiler recorded fewer than "
                           f"{calls - slack} device events in each of "
                           f"{tries} sessions of {calls} calls: its reading "
                           "would say nothing")
    per_call, by_name = read
    return per_call, {k: us / c for k, (us, c) in by_name.items()}


# ---------------------------------------------------------------------------
# the child: one tree
# ---------------------------------------------------------------------------

def _child(tree, only, clean):
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build, dps_quant, paged_attn

    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    _build.load()

    if "k5" in only:
        out["k5"] = _k5(dev, paged_attn, _build)
    if "quant" in only:
        out["quant"] = _quant(dev, dps_quant, clean)
    if "split" in only:
        out["split"] = _split(dev, dps_quant)
    if "bodies" in only and hasattr(dps_quant, "quant_plan"):
        out["bodies"] = _bodies(dev, dps_quant)
    if "k4" in only:
        out["k4"] = _k4(dev, dps_quant, _build)
    if "k3" in only:
        out["k3"] = _k3(dev, dps_quant)
    if "host" in only:
        out["host"] = _host(dev, dps_quant)
    print("KERNEL_AB " + json.dumps(out), flush=True)


def _host(dev, dps_quant):
    """The quantizer wrapper's short launches: ms between CUDA events and
    host microseconds a call."""
    import time
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    il, fl = i32(2), i32(14)
    D, F, m = 3072, 8192, 4
    blk = torch.randn(D, F // m, generator=gen, device=dev)
    bits = dps_quant.Philox(5, block=dps_quant.block_geometry(
        (D, F), (0, F // m), (D, F // m)))
    flat = blk.reshape(-1)
    cases = {
        "k1b_block": lambda: dps_quant.dps_quant(blk, il, fl, bits,
                                                 backend="kernel"),
        "k1b_block_ns": lambda: dps_quant.dps_quant(
            blk, il, fl, bits, compute_stats=False, backend="kernel"),
        "k1b_contiguous": lambda: dps_quant.dps_quant(
            flat, il, fl, dps_quant.Philox(5), backend="kernel"),
        "k1_4096": lambda: dps_quant.dps_quant(flat[:4096], il, fl,
                                               backend="kernel"),
    }
    out = {}
    for name, fn in cases.items():
        out[f"{name}_ms"] = time_ms(fn, 50)
        loops = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(500):
                fn()
            loops.append((time.perf_counter() - t) / 500 * 1e6)
            torch.cuda.synchronize()
        out[f"{name}_host_us"] = statistics.median(loops)
    return out


def _k5(dev, paged_attn, _build):
    """K5 at the serving shape and at a long context."""
    import numpy as np
    rng = np.random.default_rng(0)
    S = ATTN_SHAPE
    G = S["H"] // S["KV"]

    def attn_inputs(P, lens):
        n_pages = S["B"] * P + 1
        shp = (n_pages, S["ps"], S["KV"], S["Dh"])
        draw = lambda: np.clip(np.rint(rng.standard_normal(shp) * 32.0),
                               -128, 127).astype(np.int8)
        lens = np.asarray(lens, np.int32)
        ptab = rng.permutation(n_pages - 1)[:S["B"] * P].reshape(S["B"], P)
        ptab = ptab.astype(np.int32)
        for b in range(S["B"]):
            ptab[b, -(-int(lens[b]) // S["ps"]):] = n_pages - 1
        t = lambda a: torch.from_numpy(a).to(dev)
        return (t(rng.standard_normal((S["B"], S["H"], S["Dh"])).astype(np.float32)),
                t(draw()), t(draw()),
                t(rng.integers(5, 8, (n_pages, 2)).astype(np.int32)), t(ptab),
                t(lens))

    scale = float(S["Dh"]) ** -0.5
    k5 = {}
    for tag, P, lens in (("serve", SERVE_P, SERVE_LENS),
                         ("long", LONG_TOKENS // S["ps"],
                          [LONG_TOKENS] * S["B"])):
        args = attn_inputs(P, lens)
        call = lambda backend: paged_attn.paged_decode_attn(
            *args, scale=scale, backend=backend)
        err = float((call("kernel") - call("plain")).abs().max())
        row = {"max_abs_err": err,
               "graph_ms": time_graph_ms(lambda: call("kernel"), 100),
               "events_ms": time_ms(lambda: call("kernel"), 100)}
        if hasattr(paged_attn, "split_plan"):
            lib = _build.load()
            for tokens in (32, 64, 128):
                sp, _, ws_shape = paged_attn.split_plan(
                    P, S["ps"], S["B"], S["KV"], G, S["Dh"], 1, tokens)

                def direct(sp=sp, ws_shape=ws_shape):
                    o = torch.empty_like(args[0])
                    ws = torch.empty(ws_shape, dtype=torch.float32, device=dev)
                    code = lib.paged_decode_attn(
                        args[0].data_ptr(), args[1].data_ptr(),
                        args[2].data_ptr(), 1, args[3].data_ptr(),
                        args[4].data_ptr(), args[5].data_ptr(), o.data_ptr(),
                        ws.data_ptr(), S["B"], S["H"], S["KV"], S["Dh"],
                        S["ps"], P, sp, scale,
                        torch.cuda.current_stream().cuda_stream)
                    _build.check(lib, code, "paged_decode_attn")
                    return o

                row[f"split{tokens}_graph_ms"] = time_graph_ms(direct, 50)
        k5[tag] = row
        del args
    torch.cuda.empty_cache()
    return k5


def _block_case(dev, dps_quant, tag, seed=0):
    """K1b's block-mode inputs at ``QUANT_BLOCKS[tag]``: the block (drawn
    like init_params' normal init), its Philox source, <IL, FL> = <2, 14>."""
    whole, origin, shape = QUANT_BLOCKS[tag]
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = torch.randn(shape, generator=gen, device=dev) * whole[-2] ** -0.5
    src = dps_quant.Philox(5, block=dps_quant.block_geometry(whole, origin,
                                                             shape))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return blk, i32(2), i32(14), src


def _quant(dev, dps_quant, clean=False):
    """K1/K1b/K2/K2b at QUANT_CASES and K1b at QUANT_BLOCKS, with
    statistics and without (``clean``: the L2 flushed by a read)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    quant = {}
    for leaf in dict.fromkeys(n for _, n in QUANT_CASES):
        n = QUANT_SIZES[leaf]
        x = torch.randn(n, generator=gen, device=dev) * 0.05
        bits = None
        for kern, lf in QUANT_CASES:
            if lf != leaf:
                continue
            wire = kern.startswith("K2")
            il, fl = (i32(2), i32(6)) if wire else (i32(4), i32(12))
            if kern.endswith("b"):
                src = dps_quant.Philox(seed=1234, offset=0)
            else:
                if bits is None:
                    bits = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                         device=dev, dtype=torch.int32)
                src = bits
            fn = dps_quant.dps_quant_wire if wire else dps_quant.dps_quant
            reps = 20 if n > 10**8 else 50
            for stats in (True, False):
                quant[f"{kern}_{leaf}_{'stats' if stats else 'ns'}_ms"] = \
                    time_graph_ms(lambda: fn(x, il, fl, src, compute_stats=stats,
                                             backend="kernel"), reps,
                                  clean=clean)
        del x, bits
        torch.cuda.empty_cache()
    for tag in QUANT_BLOCKS:
        blk, il, fl, src = _block_case(dev, dps_quant, tag)
        reps = 20 if blk.numel() > 10**8 else 50
        for stats in (True, False):
            quant[f"K1b_block_{tag}_{'stats' if stats else 'ns'}_ms"] = \
                time_graph_ms(lambda: dps_quant.dps_quant(
                    blk, il, fl, src, compute_stats=stats, backend="kernel"),
                    reps, clean=clean)
        del blk
        torch.cuda.empty_cache()
    return quant


# the quantizer's two bodies side by side: (kernel, elements)
BODY_SIZES = (400_000, 3_145_728, 6_291_456, 25_165_824, 100_663_296,
              704_643_072)
BODY_KERNELS = ("K1b", "K1_nearest")


def _bodies(dev, dps_quant):
    """K1b and K1 to nearest (the launches the TMA body takes) with
    statistics on each of the tree's two bodies at BODY_SIZES, replayed
    from a CUDA graph with the L2 flushed by a read: the TMA body
    (``quant_plan`` with its size floor lifted, on a contiguous tensor) and
    the grid-stride body; ``plan`` names the one the wrapper takes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    plan = dps_quant.quant_plan
    tma = lambda n, **kw: plan(n, **{**kw, "geo": dps_quant.BlockGeometry(
        1, n, 0, 0, 0)})
    stride = lambda n, **kw: dps_quant.QuantPlan(
        "stride", dps_quant.quant_blocks(n, kw.get("groups", 1)),
        dps_quant.Q_THREADS, vec=kw.get("vec", True))
    res = {}
    try:
        for n in BODY_SIZES:
            x = torch.randn(n, generator=gen, device=dev) * 0.05
            for kern in BODY_KERNELS:
                il, fl = i32(4), i32(12)
                src = dps_quant.Philox(1234) if kern == "K1b" else None
                call = lambda: dps_quant.dps_quant(x, il, fl, src,
                                                   backend="kernel")
                reps = 20 if n > 10**8 else 50
                row = {"plan": plan(n).body}
                for body, p in (("tma", tma), ("stride", stride)):
                    dps_quant.quant_plan = p
                    row[f"{body}_ms"] = time_graph_ms(call, reps, clean=True)
                dps_quant.quant_plan = plan
                res[f"{kern}_{n}"] = row
            del x
            torch.cuda.empty_cache()
    finally:
        dps_quant.quant_plan = plan
    return res


def _split(dev, dps_quant):
    """K1b's block mode at QUANT_BLOCKS timed three ways — between CUDA
    events around the wrapper with the L2 flushed by a zero fill
    (``events``, ``chip_smoke.py``'s row), replayed from a CUDA graph with
    that flush (``graph``) and with the L2 flushed by a read (``clean``) —
    with statistics and without; the contiguous K1b launch on as many
    elements, the same three ways; and the device kernels a call launches
    with each one's device time (``torch.profiler``, 10 calls)."""
    res = {}
    for tag in QUANT_BLOCKS:
        blk, il, fl, src = _block_case(dev, dps_quant, tag)
        flat = blk.reshape(-1)
        reps = 20 if blk.numel() > 10**8 else 50
        row = {"n": blk.numel()}
        calls = {"block": lambda st: dps_quant.dps_quant(
                     blk, il, fl, src, compute_stats=st, backend="kernel"),
                 "contiguous": lambda st: dps_quant.dps_quant(
                     flat, il, fl, dps_quant.Philox(5), compute_stats=st,
                     backend="kernel")}
        for name, call in calls.items():
            for st in (True, False):
                fn = lambda: call(st)
                key = f"{name}_{'stats' if st else 'ns'}"
                row[f"{key}_events_ms"] = time_ms(fn, reps)
                row[f"{key}_graph_ms"] = time_graph_ms(fn, reps)
                row[f"{key}_clean_ms"] = time_graph_ms(fn, reps, clean=True)
                per_call, us = device_kernels(fn)
                row[f"{key}_kernels_a_call"] = per_call
                row[f"{key}_device_us"] = us
        res[tag] = row
        del blk, flat
        torch.cuda.empty_cache()
    return res


def _three_ways(fn, reps):
    """``fn`` between CUDA events (L2 zero-filled), replayed from a graph
    (zero fill), replayed with the L2 flushed by a read; its device
    kernels a call and each one's device microseconds."""
    per_call, us = device_kernels(fn)
    return {"events_ms": time_ms(fn, reps),
            "graph_ms": time_graph_ms(fn, reps),
            "clean_ms": time_graph_ms(fn, reps, clean=True),
            "kernels_a_call": per_call, "device_us": us}


def _k3(dev, dps_quant):
    """K3 at K3_ADMISSIONS, masked and unmasked, and K3b at K3B_CHUNKS,
    with statistics and without, each read by :func:`_three_ways`."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.configs.base import get_config
    from repro_torch.dist import group_layout
    from repro_torch.models import registry
    gen = torch.Generator(device=dev).manual_seed(0)
    enc = dps_quant.dps_quant_group_wire
    res = {}
    for model, (T, q) in K3_ADMISSIONS.items():
        n = T * q
        scale = torch.pow(2.0, torch.randint(-4, 4, (T, 1), generator=gen,
                                             device=dev).float())
        x = (torch.randn(T, q, generator=gen, device=dev) * scale).reshape(-1)
        x[::13] = 0.0
        mask = (torch.rand(n, generator=gen, device=dev) > 0.15).float()
        il = torch.randint(1, 6, (T,), generator=gen, device=dev)
        fl = 8 - il + torch.randint(0, 3, (T,), generator=gen, device=dev)
        tab = torch.stack([il, fl], 1).to(torch.int32).contiguous()
        tg = torch.arange(T, dtype=torch.int32, device=dev)
        for masked in (True, False):
            m = mask if masked else None
            wk, sk = enc(x, tab, tg, None, m, quantum=q, backend="kernel")
            wp, sp = enc(x, tab, tg, None, m, quantum=q, backend="plain")
            row = {"tiles": T, "quantum": q,
                   "bit_equal": bool(torch.equal(wk, wp)),
                   "stats_counts_equal": bool(torch.equal(
                       sk[:, [0, 1, 2, 6]], sp[:, [0, 1, 2, 6]])),
                   "stats_sum_rel": float(((sk[:, 3:6] - sp[:, 3:6]).abs()
                                           / sp[:, 3:6].abs().clamp(
                                               min=1e-30)).max())}
            del wk, sk, wp, sp
            row.update(_three_ways(lambda: enc(
                x, tab, tg, None, m, quantum=q, emit_stats=False,
                backend="kernel"), 50))
            res[f"K3_{model}_{'masked' if masked else 'unmasked'}"] = row
        del x, mask
        torch.cuda.empty_cache()
    for tag, (model, c) in K3B_CHUNKS.items():
        if model is None:
            lay = group_layout((4 * c,), n_chunks=4, quantum=4096)
            base = 7
        else:
            cfg = get_config(model)
            defs = registry(cfg.family).model_defs(cfg, cfg.master_dtype())
            lay = group_layout([math.prod(d.shape) for d in
                                tree_lib.leaves(defs)], n_chunks=4,
                               quantum=4096)
            base = 0
        assert lay.chunk == c, (tag, lay.chunk)
        tpc = c // 4096
        tg = torch.from_numpy(lay.tile_groups()[tpc:2 * tpc]).to(dev)
        goff = torch.tensor(lay.offsets, dtype=torch.int64, device=dev)
        G = len(lay.offsets)
        il = torch.randint(1, 3, (G,), generator=gen, device=dev)
        tab = torch.stack([il, 8 - il], 1).to(torch.int32).contiguous()
        x = torch.randn(c, generator=gen, device=dev) * 0.02
        x[::11] = 0.0
        src = dps_quant.GroupPhilox(31, goff, start=c, group_base=base)
        out = torch.empty(c, dtype=torch.int8, device=dev)
        for stats in (True, False):
            row = {"chunk": c, "groups": G}
            row.update(_three_ways(lambda: enc(
                x, tab, tg, src, None, quantum=4096, emit_stats=stats,
                out=out, backend="kernel"), 20))
            res[f"K3b_{tag}_{'stats' if stats else 'ns'}"] = row
        del x, out
        torch.cuda.empty_cache()
    return res


def _k4(dev, dps_quant, _build):
    """K4 at K4_SHAPES, and the TMA body's variants where the tree has one."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import group_layout
    from repro_torch.models import transformer
    cfg = get_config("llama3_2_3b")
    sizes = [math.prod(d.shape) for d in
             tree_lib.leaves(transformer.model_defs(cfg, cfg.master_dtype()))]
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for tag, (c, q, strided) in K4_SHAPES.items():
        if tag == "owner_803M":
            lay = group_layout(sizes, n_chunks=4, quantum=4096)
            assert lay.chunk == c, lay.chunk
            tg = torch.from_numpy(lay.tile_groups()).to(dev)[c // 4096:2 * c // 4096]
            il = torch.randint(1, 3, (len(sizes),), generator=gen, device=dev)
        else:
            tg = torch.zeros(c // q, dtype=torch.int32, device=dev)
            il = torch.ones(1, dtype=torch.int64, device=dev)
        tab = torch.stack([il, 8 - il], 1).to(torch.int32).contiguous()
        if strided:
            stack = torch.randint(-128, 128, (4, 4 * c), dtype=torch.int8,
                                  device=dev, generator=gen)
            view = stack.view(4, 4, c).transpose(0, 1)[1]
        else:
            view = torch.randint(-128, 128, (4, c), dtype=torch.int8,
                                 device=dev, generator=gen)
        call = lambda backend: dps_quant.dps_wire_reduce(
            view, tab, tg, quantum=q, backend=backend)
        reps = 100 if c < 10**6 else 20
        row = {"chunk": c, "row_stride": view.stride(0),
               "bit_equal": bool(torch.equal(call("kernel").view(torch.int32),
                                             call("plain").view(torch.int32))),
               "graph_ms": time_graph_ms(lambda: call("kernel"), reps)}
        if hasattr(dps_quant, "reduce_plan") and c > 10**6:
            lib = _build.load()
            for span, stages, bps in K4_VARIANTS:
                blocks = min(-(-c // span), bps * 132)

                def direct(span=span, stages=stages, blocks=blocks):
                    o = torch.empty(c, dtype=torch.float32, device=dev)
                    code = lib.dps_wire_reduce(
                        view.data_ptr(), view.stride(0), 4, c, tab.data_ptr(),
                        tg.data_ptr(), q, o.data_ptr(), blocks, 1, span,
                        stages, torch.cuda.current_stream().cuda_stream)
                    _build.check(lib, code, "dps_wire_reduce")
                    return o

                ok = bool(torch.equal(direct().view(torch.int32),
                                      call("plain").view(torch.int32)))
                row[f"tma_span{span}_x{stages}_{bps}perSM_graph_ms"] = (
                    time_graph_ms(direct, reps) if ok else "not bit-equal")
        res[tag] = row
        view = stack = None
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the parent: one child per tree, in order
# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="k5,quant,k4",
                    help="the kernels to time, comma-separated (k5, quant, "
                         "k4, host, split, bodies, k3)")
    ap.add_argument("--clean-l2", action="store_true",
                    help="time the quant set with the L2 flushed by a read "
                         "(clean lines) instead of a zero fill")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return _child(a.trees[0], a.only.split(","), a.clean_l2)
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py: no CUDA device; it times CUDA kernels")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lines, failed = [], 0
    for k, tree in enumerate(a.trees):
        tree = os.path.abspath(tree)
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=os.path.join(
            ROOT, "build", "kernel_ab", str(k)))
        env.pop("PYTHONPATH", None)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                            "--only", a.only, *(["--clean-l2"] if a.clean_l2
                                                else []), tree], env=env,
                           capture_output=True, text=True)
        res = [ln[len("KERNEL_AB "):] for ln in p.stdout.splitlines()
               if ln.startswith("KERNEL_AB ")]
        if p.returncode or not res:
            failed += 1
            line = json.dumps({"tree": tree, "order": k, "rc": p.returncode,
                               "error": p.stderr[-3000:]})
        else:
            d = json.loads(res[0])
            d["order"] = k
            line = json.dumps(d)
        print(line, flush=True)
        lines.append(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("\n".join([json.dumps({"nvidia_smi": smi})] + lines) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
