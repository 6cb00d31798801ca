"""The paper's Fig. 4 on the port: LeNet trained in three arms from one
initialization — fp32 (no quantization), DPS (``paper_quant_config()``)
and the naive fixed 13-bit run (``paper_quant_config(static_bits=13)``) —
and the three claims ``benchmarks/bench_convergence.py`` states for them:
DPS within 1.5 % of fp32's test accuracy, fixed 13-bit at least 1 % below
DPS or diverged, DPS's average weight and activation widths below 24.

The arms run as the bench runs them: ``MNISTLike(batch=64, seed=0)`` at
its default sizes, the paper's 2,000 steps, ``train_mnist``'s seed the
initialization (``--seeds`` runs the three arms from each of several), on
CUDA unless ``--device cpu``; every quantization event on K1b (the fused
quantizer with its Philox bits drawn in the kernel) on the card.  A seed's
initialization is drawn by the CPU generator and moved to the device, so
that a seed starts from the same parameters on every device (as the
reference's counter-based keys do).

  PYTHONPATH=src python -m repro_torch.launch.paper_eval
  PYTHONPATH=src python -m repro_torch.launch.paper_eval --device cpu \\
      --arms fp32 --seeds 0 1 2 3 --steps 300

Prints one JSON line an arm and a seed, then one with the claims for each
seed that ran all three arms.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, Optional

import torch

from repro_torch.apps import mnist as app
from repro_torch.data import MNISTLike
from repro_torch.device import resolve_device
from repro_torch.models import lenet

ARMS = ("fp32", "dps", "fixed13")
STEPS = 2000
LOSS_HEAD = 16             # the first losses printed (the early transient)


def arm_config(arm: str):
    """The arm's quantization config (``None``: fp32)."""
    return {"fp32": lambda: None, "dps": app.paper_quant_config,
            "fixed13": lambda: app.paper_quant_config(static_bits=13)}[arm]()


def run_arm(arm: str, steps: int = STEPS, seed: int = 0, device="cuda",
            data: Optional[MNISTLike] = None) -> Dict:
    """One arm from seed ``seed``'s initialization: its test accuracy, last
    loss, divergence (the bench's: a last loss not finite or above 2),
    average widths, the first losses, the first step whose loss is not
    finite (``None`` if none), wall time and ms a step."""
    device = resolve_device(device)
    data = data or MNISTLike(batch=64, seed=0)
    params = {k: v.to(device) for k, v in lenet.init(seed, "cpu").items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    hist = app.train_mnist(arm_config(arm), steps=steps, seed=seed, data=data,
                           device=device, params=params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    bad = [i for i, v in enumerate(hist["loss"]) if not math.isfinite(v)]
    return dict(arm=arm, seed=seed, steps=steps,
                final_test_acc=hist["final_test_acc"],
                final_loss=hist["loss"][-1], diverged=hist["diverged"],
                first_nonfinite_step=bad[0] if bad else None,
                first_losses=hist["loss"][:LOSS_HEAD],
                avg_bits_w=hist["avg_bits_w"], avg_bits_a=hist["avg_bits_a"],
                avg_bits_g=hist["avg_bits_g"], wall_s=wall,
                ms_per_step=1e3 * wall / steps)


def claims(arms: Dict[str, Dict]) -> Dict[str, bool]:
    """``benchmarks/bench_convergence.py``'s claims over one seed's arms."""
    fp32, dps, fixed = arms["fp32"], arms["dps"], arms["fixed13"]
    gap = fp32["final_test_acc"] - dps["final_test_acc"]
    return {"dps_matches_baseline(<1.5% gap)": bool(gap < 0.015),
            "fixed13_degrades": bool(fixed["final_test_acc"]
                                     < dps["final_test_acc"] - 0.01
                                     or fixed["diverged"]),
            "dps_avg_bits_below_24": bool(dps["avg_bits_w"] < 24
                                          and dps["avg_bits_a"] < 24)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    data = MNISTLike(batch=64, seed=0)
    out = {}
    for seed in args.seeds:
        for arm in args.arms:
            r = run_arm(arm, args.steps, seed, args.device, data)
            print(json.dumps(r), flush=True)
            out.setdefault(seed, {})[arm] = r
    verdicts = {seed: claims(arms) for seed, arms in out.items()
                if set(arms) == set(ARMS)}
    if verdicts:
        print(json.dumps({"claims": verdicts}), flush=True)
    return out, verdicts


if __name__ == "__main__":
    main()
