"""Where a quantized train step spends its time: ``torch.profiler`` over it.

Builds the trainer of ``repro_torch.launch.train`` (random weights from
``--seed`` on the GPU), runs one step to warm up, then ``--steps`` steps under
the profiler, and prints one JSON object: wall time per step, device-busy
time and share, device events per step, the quantizer kernels' and the int8
wire kernels' device time and share of the busy time (K4's alone too), and
the kernels that took most device time.  ``--trace-out`` also writes the Chrome trace.

  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch llama3_2_3b \\
      --steps 2 --batch 2 --seq 512 --optimizer sgd
  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch llama3_2_3b \\
      --steps 2 --batch 4 --seq 512 --optimizer sgd --grad-allreduce-bits 8 \\
      --data-ranks 4 [--zero-opt [--wire-overlap on]]

It takes the flags of ``repro_torch.launch.train`` plus ``--top`` and
``--trace-out``, and ``main(argv, cfg=...)`` a config of its own, as
``launch.train.main`` does (``remat="dots"``, say).  Needs a CUDA device: a
CPU profile says nothing about the card.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import train
from repro_torch.launch.profile_serve import device_us


def main(argv=None, cfg=None):
    ap = train.make_parser()
    ap.add_argument("--top", type=int, default=15,
                    help="how many kernels to list")
    ap.add_argument("--trace-out", default="",
                    help="also write the Chrome trace to this file")
    args = ap.parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_train measures the card: --device cuda only")
    cfg, step_fn, state, data = train.setup(args, cfg)
    state, m = step_fn(state, data.batch(0))              # warm-up
    float(m["loss"])
    train.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, m = step_fn(state, data.batch(1 + i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace_out:
        prof.export_chrome_trace(args.trace_out)

    by_name = {}
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0.0:
            by_name[e.key] = (us, e.count)
    busy_us = sum(us for us, _ in by_name.values())
    # K1/K1b/K2/K2b run `quantize_kernel` (so K2's time counts as the
    # quantizer's), K3/K3b `group_wire_encode_kernel`, K4
    # `wire_reduce_tma_kernel` or `wire_reduce_stride_kernel`
    quant_us = sum(us for k, (us, _) in by_name.items() if "quantize" in k)
    wire_us = sum(us for k, (us, _) in by_name.items() if "wire" in k)
    k4_us = sum(us for k, (us, _) in by_name.items() if "wire_reduce" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    n_events = sum(c for _, c in by_name.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "model": cfg.name, "layers": cfg.n_layers,
        "remat": cfg.remat,
        "batch": args.batch, "seq": args.seq, "steps": args.steps,
        "loss_last": float(m["loss"]),
        "wall_s_under_profiler": wall,
        "ms_per_step_under_profiler": 1e3 * wall / args.steps,
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall if wall else 0.0,
        "device_events_per_step": n_events / args.steps,
        "data_ranks": step_fn.n_data, "wire_sync": step_fn.wire_sync_active,
        "zero_opt": step_fn.zero_opt_active,
        "wire_overlap": step_fn.wire_overlap_active,
        "wire_buckets": step_fn.wire_buckets,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "kernel_launches": train.launch_counts(),
        "quantizer_device_ms_per_step": quant_us * 1e-3 / args.steps,
        "quantizer_share_of_busy": quant_us / busy_us if busy_us else 0.0,
        "wire_kernels_device_ms_per_step": wire_us * 1e-3 / args.steps,
        "wire_kernels_share_of_busy": wire_us / busy_us if busy_us else 0.0,
        "k4_device_ms_per_step": k4_us * 1e-3 / args.steps,
        "top_device_time": [
            {"name": k[:100], "ms": us * 1e-3, "calls": c,
             "share_of_busy": us / busy_us if busy_us else 0.0}
            for k, (us, c) in top],
    }, indent=1))


if __name__ == "__main__":
    main()
