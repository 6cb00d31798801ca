"""Where a served trace spends its time: ``torch.profiler`` over the engine.

Builds the model with random weights from ``--seed`` on the GPU, warms the
engine up, then serves a seeded synthetic trace under the profiler and prints
one JSON object: wall time, device-busy time and share, kernel launches per
decode step, and the kernels that took most device time.  ``--trace-out``
also writes the Chrome trace.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch llama3_2_3b \
      --requests 8 --slots 8 --page-size 16 --min-prompt 64 --max-prompt 512 \
      --min-new 16 --max-new 32

It takes the flags of ``repro_torch.launch.serve`` plus ``--top`` and
``--trace-out``.

Needs a CUDA device: a CPU profile says nothing about the card.
"""

from __future__ import annotations

import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import dps_quant, paged_attn
from repro_torch.launch import serve


def device_us(evt) -> float:
    """Device time of a profiler entry that ran ON the device (a kernel or a
    copy).  Host-side operator entries also carry the device time of the
    kernels they launched; counting those too would count every kernel
    twice."""
    if "cuda" not in str(getattr(evt, "device_type", "")).lower():
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None):
    ap = serve.make_parser()
    ap.add_argument("--top", type=int, default=12,
                    help="how many kernels to list")
    ap.add_argument("--trace-out", default="",
                    help="also write the Chrome trace to this file")
    args = ap.parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_serve measures the card: --device cuda only")
    cfg, eng, reqs = serve.setup(args)

    eng.run(reqs[:2])                                   # warm-up
    torch.cuda.synchronize()
    dps_quant.launch_count = paged_attn.launch_count = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rep = eng.run(reqs)
        torch.cuda.synchronize()
    if args.trace_out:
        prof.export_chrome_trace(args.trace_out)

    m = rep.metrics
    steps = int(m["decode_steps"])
    # device-side events only: kernels and memcpys, by name
    by_name = {}
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0.0:
            by_name[e.key] = (us, e.count)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    n_kernels = sum(c for _, c in by_name.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "model": cfg.name, "layers": cfg.n_layers,
        "requests": len(reqs), "total_tokens": int(m["total_tokens"]),
        "decode_steps": steps, "wall_s_under_profiler": m["wall_s"],
        "p50_ms_per_decode_step": m["p50_ms_per_step"],
        "prefill_and_encode_s_total": m["prefill_s_total"],
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / m["wall_s"] if m["wall_s"] else 0.0,
        "device_events": n_kernels,
        "device_events_per_decode_step_prefill_included": n_kernels / steps if steps else 0.0,
        "launches": {"dps_group_wire_encode": dps_quant.launch_count,
                     "paged_decode_attn": paged_attn.launch_count},
        "top_device_time": [
            {"name": k[:100], "ms": us * 1e-3, "calls": c,
             "share_of_busy": us / busy_us if busy_us else 0.0}
            for k, (us, c) in top],
    }, indent=1))
    return rep


if __name__ == "__main__":
    main()
