"""Serving CLI: the continuous-batching engine on a synthetic user trace.

Counterpart of ``repro/launch/serve.py``.  Drives :mod:`repro_torch.serve` —
prefill/decode split, strict-FCFS admission into free batch slots, paged int8
KV cache under per-page ⟨IL, FL⟩ from the ``kv_cache`` precision domain,
paged decode attention.  The trace is many users with mixed
prompt/generation lengths and Poisson arrivals, so slots churn.  Weights are
random, drawn from ``--seed``.

On the GPU (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_3b \
      --requests 16 --slots 8 --page-size 16 --max-prompt 512 --max-new 64

Smoke scale on the CPU (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_3b \
      --smoke --device cpu --requests 8 --slots 4 --page-size 4
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke as smoke_cfg
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.common import init_params
from repro_torch.serve import (Engine, EngineConfig, PagedLayout,
                               supports_paging, synthetic_trace)
from repro_torch.serve.engine import BACKENDS


def build_layout(args) -> PagedLayout:
    ps = args.page_size
    max_prompt = -(-args.max_prompt // ps) * ps     # round up to a page
    prompt_pages = max_prompt // ps
    pages_per_seq = max(prompt_pages + -(-args.max_new // ps) + 1,
                        args.pages_per_seq)
    n_pages = args.pages or max(args.slots * pages_per_seq,
                                2 * prompt_pages)
    return PagedLayout(page_size=ps, n_pages=n_pages,
                       batch_slots=args.slots,
                       max_pages_per_seq=pages_per_seq,
                       max_prompt=max_prompt)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda launches the kernels; cpu runs their plain "
                         "versions")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic trace length (distinct users)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode rows")
    ap.add_argument("--page-size", type=int, default=4,
                    help="tokens per KV page (one page = one <IL,FL> group)")
    ap.add_argument("--pages", type=int, default=0,
                    help="pool size in pages (0 = derive from slots)")
    ap.add_argument("--pages-per-seq", type=int, default=0,
                    help="page-table width floor per row")
    ap.add_argument("--max-prompt", type=int, default=16,
                    help="prompt length ceiling")
    ap.add_argument("--max-new", type=int, default=16,
                    help="trace generation-length ceiling")
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--min-new", type=int, default=4)
    ap.add_argument("--mean-gap", type=float, default=0.5,
                    help="mean inter-arrival gap in engine steps")
    ap.add_argument("--kv-bits", default="8",
                    help="8 = int8 DPS pages; none = fp32 pages (parity "
                         "baseline)")
    ap.add_argument("--serial", action="store_true",
                    help="one request at a time (continuous batching off)")
    ap.add_argument("--attn-backend", default="auto", choices=BACKENDS)
    ap.add_argument("--encode-backend", default="auto", choices=BACKENDS)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def setup(args):
    """Model with random weights from ``--seed``, engine and trace for the
    parsed arguments.  Returns ``(cfg, engine, requests)``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    if not supports_paging(cfg):
        raise SystemExit(f"{cfg.name}: family {cfg.family!r} has no paged "
                         f"decode path (dense GQA models only)")
    mod = registry(cfg.family)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(mod.model_defs(cfg), device, gen)

    layout = build_layout(args)
    kv_bits = None if args.kv_bits.lower() in ("none", "0", "32") else \
        int(args.kv_bits)
    eng = Engine(cfg, params, EngineConfig(
        layout=layout, kv_bits=kv_bits, attn_backend=args.attn_backend,
        encode_backend=args.encode_backend,
        max_concurrency=1 if args.serial else None), device=device)

    reqs = synthetic_trace(
        args.requests, cfg.vocab,
        prompt_lens=(args.min_prompt, min(args.max_prompt,
                                          layout.max_prompt)),
        new_tokens=(args.min_new, args.max_new),
        mean_gap=args.mean_gap, seed=args.seed + 1)
    return cfg, eng, reqs


def main(argv=None):
    args = make_parser().parse_args(argv)
    cfg, eng, reqs = setup(args)
    layout = eng.layout
    report = eng.run(reqs)

    m = report.metrics
    bits = "int8" if eng.bits == 8 else "fp32"
    mode = "serial" if args.serial else "continuous"
    print(f"layout: {layout.n_pages} pages × {layout.page_size} tok, "
          f"{layout.batch_slots} slots ({mode}, {bits} pages, "
          f"attn={eng._attn_backend}, encode={eng._enc_backend})")
    print(f"served {len(reqs)} requests, {int(m['total_tokens'])} tokens "
          f"in {m['wall_s']:.3f}s -> {m['tokens_per_s']:.1f} tok/s")
    print(f"decode: {int(m['decode_steps'])} steps, mean occupancy "
          f"{m['mean_occupancy']:.2f}/{layout.batch_slots}, per-token "
          f"p50 {m['p50_ms_per_token']:.2f}ms p95 {m['p95_ms_per_token']:.2f}ms")
    if report.format_spread:
        spread = Counter(report.format_spread)
        total = sum(spread.values())
        pretty = ", ".join(f"{k}:{v}" for k, v in spread.most_common())
        print(f"per-page <IL,FL> spread over {total} live page-rows: "
              f"{pretty}")
    sample = report.tokens[reqs[0].rid]
    print("sample:", np.asarray(sample)[:16].tolist())
    return report


if __name__ == "__main__":
    main()
