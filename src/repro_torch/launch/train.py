"""Training CLI: quantized (DPS) training of a language model.

Counterpart of ``repro/launch/train.py`` (without checkpointing).  Each
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

Data parallelism over the int8 wire (``--grad-allreduce-bits 8``): each of
``--data-ranks N`` ranks runs its forward and backward on its slice of the
batch, and the gradients are averaged by the int8 tree all-reduce (K2b per
leaf, K4 per owner chunk, K3b on the gather leg; K2 and K3 with a bits
operand under ``--rounding-bits operand``) under the ``wire_grads``
precision domain.  ``--data-ranks N`` holds the N ranks in this process, on
one device; under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) each
process is one rank on ``cuda:LOCAL_RANK`` (gloo with ``--device cpu``),
the collectives run over ``torch.distributed``, and rank 0 logs:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \\
      --steps 4 --batch 4 --seq 512 --optimizer sgd --grad-allreduce-bits 8 \\
      --data-ranks 4

ZeRO-1 (``--zero-opt``): the optimizer state shards over the data axis;
the parameters live in one flat fp32 buffer whose slices the owners step,
the gradients reach each owner through the int8 reduce-scatter, and the
updated parameters come back through the int8 ``wire_params`` all-gather
when the policy quantizes every leaf (else in fp32).  ``--wire-overlap on``
splits the wire into buckets, each encoded leaf by leaf from a hook as the
backward produces its gradients and sent once complete:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \\
      --steps 4 --batch 4 --seq 512 --optimizer sgd --grad-allreduce-bits 8 \\
      --data-ranks 4 --zero-opt --wire-overlap on

Not ported yet: checkpointing and resume, the health guards and fault
injection of the reference's CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs.base import get_config, smoke as smoke_cfg
from repro_torch.core import qtrain
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.device import resolve_device
from repro_torch.dist import ProcessGroupTransport, StackedTransport
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
    ap.add_argument("--grad-allreduce-bits", type=int, default=None,
                    help="average the gradients over the data-parallel "
                         "ranks through an int8 wire of this many grid bits "
                         "(2-8), its format chosen by the wire_grads "
                         "precision domain")
    ap.add_argument("--wire-controller", default="flexpoint",
                    help="DPS controller kind of the wire_grads domain")
    ap.add_argument("--wire-groups", choices=("per-layer", "global"),
                    default="per-layer",
                    help="granularity of the wire_grads <IL, FL>: one per "
                         "gradient leaf (the group-aligned collectives) or "
                         "one shared format")
    ap.add_argument("--wire-auto-slack", action="store_true",
                    help="place the wire radix from each stream's measured "
                         "tail quantile instead of the fixed slack")
    ap.add_argument("--zero-opt", action="store_true",
                    help="ZeRO-1: shard the optimizer state over the data "
                         "axis; with --grad-allreduce-bits the gradient "
                         "reduce-scatter and the parameter all-gather ride "
                         "the int8 wire")
    ap.add_argument("--wire-overlap", choices=("on", "off"), default="off",
                    help="backward-overlapped bucketed wire: one compressed "
                         "collective per bucket of gradient leaves, each "
                         "sent as soon as the backward has produced it "
                         "(needs --grad-allreduce-bits)")
    ap.add_argument("--data-ranks", type=int, default=1,
                    help="data-parallel ranks held by this process (one "
                         "device); under torchrun each process is one rank")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


# the launch counters of every kernel on the training path, by kernel name
LAUNCH_COUNTERS = {
    "dps_quantize": "quantize_launch_count",
    "dps_quantize_onchip_prng": "quantize_prng_launch_count",
    "dps_quant_wire": "wire_launch_count",
    "dps_quant_wire_onchip_prng": "wire_prng_launch_count",
    "dps_group_wire_encode": "launch_count",
    "dps_group_wire_encode_onchip_prng": "group_prng_launch_count",
    "dps_wire_reduce": "reduce_launch_count",
}


def launch_counts() -> dict:
    return {k: getattr(dps_quant, v) for k, v in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    for v in LAUNCH_COUNTERS.values():
        setattr(dps_quant, v, 0)


def _transport(args, device):
    """The data-parallel transport: ``torch.distributed`` under torchrun
    (``WORLD_SIZE`` > 1), else ``--data-ranks`` ranks in this process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        if args.data_ranks != 1:
            raise ValueError("--data-ranks holds ranks in one process; under "
                             "torchrun each process is one rank")
        return ProcessGroupTransport()
    if args.data_ranks < 1:
        raise ValueError(f"--data-ranks must be >= 1, got {args.data_ranks}")
    return StackedTransport(args.data_ranks, device)


def _init_distributed(args):
    """Under torchrun: join the process group (NCCL between cards, gloo on
    the CPU) and return this process's device; else None."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    import torch.distributed as dist
    if args.device == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def setup(args):
    """(cfg, step_fn, state, data) for parsed CLI ``args``: the model's
    parameters drawn from ``--seed`` on the device, the optimizer, the
    quantized train step and the synthetic token stream."""
    device = resolve_device(args.device)
    device = _init_distributed(args) or device
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    qcfg = qtrain.QuantConfig(enabled=args.controller != "off",
                              controller=args.controller
                              if args.controller != "off" else "paper",
                              onchip_prng=args.rounding_bits == "onchip",
                              grad_allreduce_bits=args.grad_allreduce_bits,
                              wire_controller=args.wire_controller,
                              wire_auto_slack=args.wire_auto_slack,
                              wire_overlap=args.wire_overlap == "on")
    mod = registry(cfg.family)
    defs = mod.model_defs(cfg, cfg.master_dtype())
    if args.wire_groups == "per-layer":
        qcfg = qcfg.with_per_layer_wire(defs)
    transport = _transport(args, device)
    if args.zero_opt and transport.axis_size > 1:
        qcfg = dataclasses.replace(qcfg, zero_opt_shards=transport.axis_size)
    if args.batch % transport.axis_size:
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{transport.axis_size} data-parallel ranks")
    opt_cfg = (AdamWConfig(total_steps=args.steps) if args.optimizer == "adamw"
               else SGDConfig())
    opt = make_optimizer(opt_cfg)
    step_fn = qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg,
                                     accum_steps=cfg.train_accum,
                                     transport=transport)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch,
                                         seed=args.seed), device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(defs, device, gen)
    if step_fn.zero_opt_active:
        # the parameters move into the flat ZeRO buffer (the tree becomes
        # views of it) before the optimizer state is made beside them
        _, params = qtrain.zero_partitioner(
            qcfg, params, transport.axis_size).flat_view(params)
        opt_state = qtrain.zero_opt_state(opt, params, transport, qcfg)
    else:
        opt_state = opt.init(params)
    state = qtrain.TrainState.create(params, opt_state, qcfg,
                                     args.seed + 1, device)
    return cfg, step_fn, state, data


def _wire_log(m) -> str:
    """The wire_grads format in the log line: mean(min-max) when per-layer."""
    if "il_wire_grads" not in m:
        return ""
    il, fl = m["il_wire_grads"], m["fl_wire_grads"]
    if "il_wire_grads_min" in m:
        return (f"wg<{il:.1f}({m['il_wire_grads_min']:.0f}-"
                f"{m['il_wire_grads_max']:.0f}),{fl:.1f}("
                f"{m['fl_wire_grads_min']:.0f}-{m['fl_wire_grads_max']:.0f})> ")
    return f"wg<{il:.0f},{fl:.0f}> "


def main(argv=None):
    """Run the CLI; returns the summary it prints (plus the full history)."""
    args = make_parser().parse_args(argv)
    cfg, step_fn, state, data = setup(args)
    device = state.last_loss.device
    cuda = device.type == "cuda"
    rank0 = int(os.environ.get("RANK", "0")) == 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    history, pending = [], []

    def _drain():
        """One host sync for the whole pending window (the step loop never
        blocks on metrics)."""
        for m, n in pending:
            h = {k: float(v) for k, v in m.items()}
            h["launches"] = n["dps_quantize"] + n["dps_quantize_onchip_prng"]
            h["kernel_launches"] = n
            history.append(h)
        pending.clear()

    t_first = None
    t0 = time.perf_counter()
    for step in range(args.steps):
        before = launch_counts()
        state, metrics = step_fn(state, data.batch(step))
        pending.append((metrics, {k: v - before[k]
                                  for k, v in launch_counts().items()}))
        if step == 0:
            if cuda:
                torch.cuda.synchronize(device)
            t_first = time.perf_counter()
        if step % args.log_every == 0 or step == args.steps - 1:
            _drain()
            m = history[-1]
            wire = ""
            if "E_wire" in m:
                wire = f" E_wire {m['E_wire']:.2e} R_wire {m['R_wire']:.2e}"
            if rank0:
                print(f"step {step:5d} loss {m['loss']:8.4f} "
                      f"w<{m['il_w']:.0f},{m['fl_w']:.0f}> "
                      f"a<{m['il_a']:.0f},{m['fl_a']:.0f}> "
                      f"g<{m['il_g']:.0f},{m['fl_g']:.0f}> {_wire_log(m)}"
                      f"E_a {m['E_a']:.2e} R_a {m['R_a']:.2e}{wire}",
                      flush=True)
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    _drain()
    rest = args.steps - 1
    wire_kernels = ("dps_quant_wire", "dps_quant_wire_onchip_prng",
                    "dps_wire_reduce", "dps_group_wire_encode",
                    "dps_group_wire_encode_onchip_prng")
    out = {"final_loss": history[-1]["loss"] if history else None,
           "history_tail": history[-5:],
           "device": (torch.cuda.get_device_name(device) if cuda
                      else "cpu"),
           "params": cfg.n_params(),
           "data_ranks": step_fn.n_data,
           "wire_sync": step_fn.wire_sync_active,
           "zero_opt": step_fn.zero_opt_active,
           "zero_groupaligned": step_fn.zero_groupaligned_active,
           "wire_overlap": step_fn.wire_overlap_active,
           "wire_buckets": step_fn.wire_buckets,
           "first_step_s": (t_first - t0) if t_first else None,
           "ms_per_step_after_first": (1e3 * (t_end - t_first) / rest
                                       if rest > 0 else None),
           "tokens_per_s_after_first": (args.batch * args.seq * rest
                                        / (t_end - t_first)
                                        if rest > 0 else None),
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None),
           "quantizer_launches_per_step": [h["launches"] for h in history],
           "launches_per_step": [h["kernel_launches"] for h in history],
           "wire_launches_per_step": [
               {k: h["kernel_launches"][k] for k in wire_kernels}
               for h in history],
           "E_wire": history[-1].get("E_wire") if history else None,
           "R_wire": history[-1].get("R_wire") if history else None}
    if rank0:
        print(json.dumps(out, indent=1))
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    out["history"] = history
    return out


if __name__ == "__main__":
    main()
