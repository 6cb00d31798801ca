"""Time the port's hand-written kernels of several source trees side by side
on one card.

    python3 kernel_ab.py [--out FILE] [--only k5,quant,k4] TREE [TREE ...]

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
  w_in leaf), K2 (bits operand) and K2b (Philox) onto the int8 wire, with
  statistics and without, each replayed from a CUDA graph;
* the wire's decode-and-mean K4 at four shapes of 4 int8 rows: owner 1's
  strided view of the full llama3.2-3b tree's [4, 4c] stack (c =
  803,385,344, per-layer formats), owner 1's view at the overlap run's w_in
  bucket (c = 176,160,768, one format), at that run's smallest bucket (the
  final norm: c = 3,072, quantum 3,072), and a contiguous [4, 176,160,768]
  stack as the process-group transport delivers it; each replayed from a
  CUDA graph and held bit-equal to the tree's plain version; and, for a tree
  whose K4 has a TMA body (``reduce_plan``), its time launched through the
  library's C entry at the wrapper's setting and at other spans, stage
  counts and grids.

Every time is the median over repeated launches with the 50 MB L2 cache
overwritten before each, as in ``chip_smoke.py``.

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
# (kernel, leaf) pairs timed; each with statistics and without
QUANT_CASES = [("K1b", "lenet_fc1"), ("K1b", "proj"), ("K1b", "w_in"),
               ("K1", "lenet_fc1"), ("K1", "w_in_layer"),
               ("K2", "w_in"), ("K2b", "lenet_fc1"), ("K2b", "w_in")]


# ---------------------------------------------------------------------------
# timing (chip_smoke.py times its kernels with these too)
# ---------------------------------------------------------------------------

_flush = None


def time_ms(fn, repeats, warmup=3):
    """Median milliseconds of ``fn()`` by CUDA events, one pair per launch,
    the 50 MB L2 cache overwritten before each so the call finds it cold, as
    it does between two layers of the serving path."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
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


def time_graph_ms(fn, repeats, warmup=3):
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
    ms = time_ms(graph.replay, repeats, warmup=0)
    del graph
    return ms


# ---------------------------------------------------------------------------
# the child: one tree
# ---------------------------------------------------------------------------

def _child(tree, only):
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build, dps_quant, paged_attn

    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    _build.load()

    if "k5" in only:
        out["k5"] = _k5(dev, paged_attn, _build)
    if "quant" in only:
        out["quant"] = _quant(dev, dps_quant)
    if "k4" in only:
        out["k4"] = _k4(dev, dps_quant, _build)
    print("KERNEL_AB " + json.dumps(out), flush=True)


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


def _quant(dev, dps_quant):
    """K1/K1b/K2/K2b at QUANT_CASES, with statistics and without."""
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
                                             backend="kernel"), reps)
        del x, bits
        torch.cuda.empty_cache()
    return quant


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
                    help="the kernels to time, comma-separated")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return _child(a.trees[0], a.only.split(","))
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
                            "--only", a.only, tree], env=env,
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
