"""Training CLI: quantized (DPS) training of a language model.

Counterpart of ``repro/launch/train.py``, replicated one-device path.  Each
step quantizes the weights, runs the forward with a tap on every block's
residual stream and the backward with the cotangents quantized, quantizes
the gradients, steps the optimizer, re-snaps the weights and lets one
controller per precision domain pick the next ⟨IL, FL⟩ — every
quantization event one launch of the fused quantizer kernel (K1b, Philox
bits drawn in the kernel, by default; ``--rounding-bits operand`` hands it
``torch.randint`` bits instead: K1).  Weights are random, drawn from
``--seed``; the data is the synthetic token stream.

On the GPU (the default device), full size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \\
      --steps 4 --batch 2 --seq 512 --optimizer sgd --log-every 1

Smoke scale on the CPU (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \\
      --smoke --device cpu --steps 6 --batch 2 --seq 16 --log-every 2

Not ported yet: checkpointing and resume, the health guards, fault
injection and the int8 wire flags of the reference's CLI.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config, smoke as smoke_cfg
from repro_torch.core import qtrain
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dps_quant
from repro_torch.models import registry
from repro_torch.models.common import init_params
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda launches the kernels; cpu runs their plain "
                         "versions")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", choices=("sgd", "adamw"), default="adamw")
    ap.add_argument("--controller", default="paper",
                    help="DPS controller (paper|courbariaux|na_mukhopadhyay|"
                         "static|flexpoint) or 'off'")
    ap.add_argument("--rounding-bits", choices=("onchip", "operand"),
                    default="onchip",
                    help="stochastic-rounding bits: drawn inside the "
                         "quantizer kernel (K1b) or handed to it as an "
                         "operand (K1)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _launches() -> int:
    return dps_quant.quantize_launch_count + dps_quant.quantize_prng_launch_count


def setup(args):
    """(cfg, step_fn, state, data) for parsed CLI ``args``: the model's
    parameters drawn from ``--seed`` on the device, the optimizer, the
    quantized train step and the synthetic token stream."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    qcfg = qtrain.QuantConfig(enabled=args.controller != "off",
                              controller=args.controller
                              if args.controller != "off" else "paper",
                              onchip_prng=args.rounding_bits == "onchip")
    opt_cfg = (AdamWConfig(total_steps=args.steps) if args.optimizer == "adamw"
               else SGDConfig())
    opt = make_optimizer(opt_cfg)
    mod = registry(cfg.family)
    step_fn = qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg,
                                     accum_steps=cfg.train_accum)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch,
                                         seed=args.seed), device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(mod.model_defs(cfg, cfg.master_dtype()), device, gen)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                     args.seed + 1, device)
    return cfg, step_fn, state, data


def main(argv=None):
    """Run the CLI; returns the summary it prints (plus the full history)."""
    args = make_parser().parse_args(argv)
    cfg, step_fn, state, data = setup(args)
    device = state.last_loss.device
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    history, pending = [], []

    def _drain():
        """One host sync for the whole pending window (the step loop never
        blocks on metrics)."""
        for m, n in pending:
            h = {k: float(v) for k, v in m.items()}
            h["launches"] = n
            history.append(h)
        pending.clear()

    t_first = None
    t0 = time.perf_counter()
    for step in range(args.steps):
        before = _launches()
        state, metrics = step_fn(state, data.batch(step))
        pending.append((metrics, _launches() - before))
        if step == 0:
            if cuda:
                torch.cuda.synchronize()
            t_first = time.perf_counter()
        if step % args.log_every == 0 or step == args.steps - 1:
            _drain()
            m = history[-1]
            print(f"step {step:5d} loss {m['loss']:8.4f} "
                  f"w<{m['il_w']:.0f},{m['fl_w']:.0f}> "
                  f"a<{m['il_a']:.0f},{m['fl_a']:.0f}> "
                  f"g<{m['il_g']:.0f},{m['fl_g']:.0f}> "
                  f"E_a {m['E_a']:.2e} R_a {m['R_a']:.2e}", flush=True)
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    _drain()
    rest = args.steps - 1
    out = {"final_loss": history[-1]["loss"] if history else None,
           "history_tail": history[-5:],
           "device": (torch.cuda.get_device_name(device) if cuda
                      else "cpu"),
           "params": cfg.n_params(),
           "first_step_s": (t_first - t0) if t_first else None,
           "ms_per_step_after_first": (1e3 * (t_end - t_first) / rest
                                       if rest > 0 else None),
           "tokens_per_s_after_first": (args.batch * args.seq * rest
                                        / (t_end - t_first)
                                        if rest > 0 else None),
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None),
           "quantizer_launches_per_step": [h["launches"] for h in history]}
    print(json.dumps(out, indent=1))
    out["history"] = history
    return out


if __name__ == "__main__":
    main()
