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

The MoE and VLM families train the same way (``--arch qwen3_moe_30b_a3b``,
and ``--arch deepseek_v2_236b``, MoE with MLA and 4 microbatches a step;
``--arch internvl2_26b``, whose batches carry zero patch embeddings for
the stubbed vision frontend, prepended to the tokens); so do the SSM,
hybrid and encoder-decoder families (``--arch mamba2_1_3b``, ``--arch
zamba2_7b``, ``--arch whisper_medium``, whose batches carry zero frame
embeddings for the stubbed audio frontend).  Above S_q·S_k = 4096·2048
(``--seq 3000`` at smoke width) attention runs blockwise.

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

Fault tolerance, as the reference's CLI has it:

* ``--ckpt-dir D`` writes an atomic, digest-verified checkpoint (the
  reference's format, :mod:`repro_torch.checkpoint`) every ``--ckpt-every``
  steps and at the end; ``--resume`` restores the newest good one (walking
  back past torn or corrupt steps) and goes on from its step;
* SIGTERM/SIGINT checkpoint on the way down and exit 0 (``PREEMPTED``);
  ``--sigterm-at N`` sends this process a real SIGTERM after step N;
* the crash path: ``--fail-at N`` (an injected failure) or a step over
  ``--step-timeout`` seconds (the watchdog; it synchronizes the device each
  step) checkpoints and exits 17 (``ABORT``);
* ``--guards`` arms the health guards (:mod:`repro_torch.resilience`): the
  skip gate, the int8 wire's fp32 fallback for ``--guard-cooldown`` clean
  steps after a trip; a health word suffixes the log line (``!grads-
  nonfinite,...``); ``--inject-nan-at``, ``--inject-storm-at`` and
  ``--inject-wire-flip-at`` fire the faults they catch;
* ``--rollback-ring K`` keeps the last K healthy states on the host and
  rolls back to the newest on a median-filtered loss spike
  (``--rollback-spike``), forcing the wire into its fp32 fallback.

Preempt and resume on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \\
      --smoke --device cpu --steps 6 --batch 4 --seq 8 \\
      --grad-allreduce-bits 8 --data-ranks 2 --sigterm-at 3 --ckpt-dir D
  (the same with ``--resume`` instead of ``--sigterm-at 3``)

The guards and the fault plan run on every step: replicated, the monolithic
and the overlapped wire, ZeRO-1 (each wire leg degrades on its own) and
the placed step on a caller's mesh (``main(argv, mesh=...)``; there the
int8 wire and ZeRO-1 fall back under a model axis and a rollback-ring
entry is a host copy of each block this process holds); the wire flip
needs the monolithic wire, as in the reference.  Under
``torchrun`` with ``--zero-opt`` each process holds one rank's optimizer
shard: a save gathers the rows to rank 0, which writes the stacked run's
arrays, and ``--resume`` gives each process its own row back:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch llama3_2_3b \\
      --smoke --device cpu --steps 4 --batch 4 --seq 8 \\
      --grad-allreduce-bits 8 --zero-opt --ckpt-dir D --sigterm-at 2
  (the same with ``--resume`` instead of ``--sigterm-at 2``)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, flatten_tree,
                                    gather_rows, latest_step, load_flat,
                                    restore)
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--guards", action="store_true",
                    help="arm the health guards: in-step NaN/overflow/spike "
                         "detection, the skip gate, and the int8 wire's fp32 "
                         "fallback with a cooldown re-arm")
    ap.add_argument("--guard-cooldown", type=int, default=16,
                    help="clean steps before a degraded wire domain re-arms "
                         "its int8 codec")
    ap.add_argument("--rollback-ring", type=int, default=0,
                    help="keep the last K healthy train states in host "
                         "memory (snapshotted at log points) and roll back "
                         "to the newest on a median-filtered loss spike; 0 "
                         "disables")
    ap.add_argument("--rollback-spike", type=float, default=10.0,
                    help="drained loss > this factor times the median of the "
                         "recent drained losses triggers a rollback")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a crash after N steps (restart test)")
    ap.add_argument("--sigterm-at", type=int, default=0,
                    help="send SIGTERM to this process after N steps "
                         "(pre-emption test: checkpoint + exit 0)")
    ap.add_argument("--inject-nan-at", type=int, default=-1,
                    help="fault injection: NaN gradients at this step")
    ap.add_argument("--inject-storm-at", type=int, default=-1,
                    help="fault injection: overflow-storm gradient scale "
                         "starting at this step")
    ap.add_argument("--inject-wire-flip-at", type=int, default=-1,
                    help="fault injection: XOR a bit into the int8 wire "
                         "payload at this step")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="straggler watchdog: a step longer than this many "
                         "seconds checkpoints and exits 17")
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


def setup(args, cfg=None, mesh=None):
    """(cfg, step_fn, state, data) for parsed CLI ``args``: the model's
    parameters drawn from ``--seed`` on the device, the optimizer, the
    quantized train step and the synthetic token stream.  ``cfg``, if
    given, is the model's config in place of ``--arch``'s (a config cut
    in depth, say), as the reference's ``build(cfg, ...)`` takes one.
    ``mesh`` (a :class:`~repro_torch.dist.sharding.StackedMesh` or a
    ``DeviceMesh``, from ``launch.mesh.make_mesh``) replaces
    ``--data-ranks``: the step is ``launch.specs.build_train_step``'s on
    it (``step_fn.placed`` when it places the state; the state is whole
    here, :func:`main` places it)."""
    device = resolve_device(args.device)
    if mesh is not None:
        device = getattr(mesh, "device", None) or device
    device = _init_distributed(args) or device
    cfg = cfg or get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    guards = faults = None
    if args.guards:
        from repro_torch.resilience import GuardConfig
        guards = GuardConfig(cooldown=args.guard_cooldown)
    if (args.inject_nan_at >= 0 or args.inject_storm_at >= 0
            or args.inject_wire_flip_at >= 0):
        from repro_torch.resilience import FaultPlan
        faults = FaultPlan(nan_grads_at=args.inject_nan_at,
                           overflow_storm_at=args.inject_storm_at,
                           wire_flip_at=args.inject_wire_flip_at)
    qcfg = qtrain.QuantConfig(enabled=args.controller != "off",
                              controller=args.controller
                              if args.controller != "off" else "paper",
                              onchip_prng=args.rounding_bits == "onchip",
                              grad_allreduce_bits=args.grad_allreduce_bits,
                              wire_controller=args.wire_controller,
                              wire_auto_slack=args.wire_auto_slack,
                              wire_overlap=args.wire_overlap == "on",
                              guards=guards)
    mod = registry(cfg.family)
    defs = mod.model_defs(cfg, cfg.master_dtype())
    if args.wire_groups == "per-layer":
        qcfg = qcfg.with_per_layer_wire(defs)
    if mesh is not None:
        if args.data_ranks != 1:
            raise ValueError("--data-ranks builds a data axis; a mesh has "
                             "its own")
        from repro_torch.dist.sharding import _axis_sizes, axis_transport
        transport = (axis_transport(mesh, "data")
                     if "data" in _axis_sizes(mesh) else StackedTransport(1))
    else:
        transport = _transport(args, device)
    if args.zero_opt and transport.axis_size > 1:
        qcfg = dataclasses.replace(qcfg, zero_opt_shards=transport.axis_size)
    if args.batch % transport.axis_size:
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{transport.axis_size} data-parallel ranks")
    opt_cfg = (AdamWConfig(total_steps=args.steps) if args.optimizer == "adamw"
               else SGDConfig())
    opt = make_optimizer(opt_cfg)
    if mesh is not None:
        from repro_torch.launch import specs
        step_fn = specs.build_train_step(cfg, qcfg, opt, mesh=mesh,
                                         faults=faults)
    else:
        step_fn = qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg,
                                         accum_steps=cfg.train_accum,
                                         transport=transport, faults=faults)
    extras = {}
    if cfg.family == "encdec":
        # the stubbed audio frontend's frame embeddings, as the reference's
        # CLI feeds them: zeros
        extras["frames"] = torch.zeros(
            (args.batch, cfg.enc_seq, cfg.d_model), dtype=torch.float32,
            device=device)
    if cfg.family == "vlm":
        # the stubbed vision frontend's patch embeddings, as the
        # reference's CLI feeds them: zeros
        extras["vision_embeds"] = torch.zeros(
            (args.batch, cfg.n_patches, cfg.d_model), dtype=torch.float32,
            device=device)
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         global_batch=args.batch,
                                         seed=args.seed), device, extras)
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


def _resume(args, step_fn, state):
    """Restore the newest good checkpoint of ``--ckpt-dir`` into ``state``
    in place; returns ``(start step, timings)`` (start 0 when there is
    none)."""
    t0 = time.perf_counter()
    found = latest_step(args.ckpt_dir)
    info = {"verify_s": time.perf_counter() - t0}
    if found is None:
        return 0, info
    qcfg = step_fn.qcfg
    # domains or a guard subtree the checkpoint predates start fresh
    defaults = qtrain.dps_restore_defaults(qcfg)
    defaults.update(qtrain.guard_restore_defaults(qcfg))
    adapt = None
    if step_fn.zero_opt_active:
        from repro_torch.convert import zero_ckpt_adapter
        adapt = zero_ckpt_adapter(state.params, qcfg, step_fn.transport)
    t0 = time.perf_counter()
    _, meta = restore(args.ckpt_dir, found, state, defaults=defaults,
                      adapt=adapt)
    if state.last_loss.is_cuda:
        torch.cuda.synchronize(state.last_loss.device)
    info.update(step=found, restore_s=time.perf_counter() - t0,
                cursor=meta.get("cursor"))
    return found, info


def _force_degrade(state, cooldown: int):
    """After a rollback: every wire domain in its fp32 fallback for a full
    cooldown, so the replayed window cannot re-trip on the same fault."""
    g = state.guard
    if g is None or g.degraded.numel() == 0:
        return
    state.guard = dataclasses.replace(
        g, degraded=torch.ones_like(g.degraded),
        cooldown=torch.full_like(g.cooldown, cooldown))


def _held_blocks(state):
    """Each distinct block of every placed leaf of the parameters and the
    optimizer state, in leaf order: what this process holds."""
    from repro_torch.core import tree as tree_lib
    return [b for tree in (state.params, state.opt_state)
            for leaf in tree_lib.leaves(tree) for _, b in leaf.distinct()]


def _snapshot(state, placed: bool):
    """A rollback-ring entry: the whole state on the host, or on a placed
    state a host copy of each block this process holds (no gather, no
    collective) beside the replicated step, DPS and guard state."""
    if not placed:
        return flatten_tree(state)
    return ([b.detach().to("cpu", copy=True) for b in _held_blocks(state)],
            flatten_tree(dataclasses.replace(state, params=None,
                                             opt_state=None)))


def _roll_back(state, snap, placed: bool) -> None:
    """``state`` set back to ring entry ``snap`` in place: on a placed
    state each held block is copied back into itself, so every ``Placed``
    and every block two ranks share survive, and the step runs on."""
    if not placed:
        load_flat(state, snap.get)
        return
    blocks, rest = snap
    with torch.no_grad():
        for b, host in zip(_held_blocks(state), blocks):
            b.copy_(host)
    scalars = dataclasses.replace(state, params=None, opt_state=None)
    load_flat(scalars, rest.get)
    state.step, state.seed = scalars.step, scalars.seed


def _health_log(m) -> str:
    if not m.get("health"):
        return ""
    from repro_torch.resilience import health_flags
    return " !" + ",".join(health_flags(int(m["health"])))


def main(argv=None, on_step=None, cfg=None, mesh=None):
    """Run the CLI; returns the summary it prints (plus the full history).
    A pre-empted run returns ``{"preempted_at": step, "history": ...}``;
    the crash path raises ``SystemExit(17)``.  ``on_step(step, state)``,
    if given, is called after every step (a caller that inspects the state
    between steps, as the smoke run's skip check does).  ``cfg`` and
    ``mesh`` go to :func:`setup` (no CLI flag sets them: the reference's
    CLI builds no model axis); on a mesh that places the state the
    summary adds each held rank's bytes of parameters and optimizer state
    (``held_bytes_per_rank``)."""
    args = make_parser().parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    main_thread = threading.current_thread() is threading.main_thread()
    if args.sigterm_at and not main_thread:
        raise ValueError("--sigterm-at needs the main thread, where the "
                         "SIGTERM handler runs")
    cfg, step_fn, state, data = setup(args, cfg, mesh)
    placed = getattr(step_fn, "placed", False)
    device = state.last_loss.device
    cuda = device.type == "cuda"
    process_mesh = hasattr(mesh, "mesh_dim_names")
    if process_mesh:
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0
    else:
        rank0 = int(os.environ.get("RANK", "0")) == 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir and rank0 else None
    start, resumed = 0, None
    if args.resume and args.ckpt_dir:
        start, resumed = _resume(args, step_fn, state)
        if "step" in resumed and rank0:
            print(f"resumed from step {start} (data cursor "
                  f"{resumed['cursor']})", flush=True)
    if placed:
        # a checkpoint restores whole, onto any mesh: placed after it
        from repro_torch.dist.sharding import held_bytes
        from repro_torch.launch import specs
        specs.place_train_state(cfg, state, mesh)
        held = [p + o for p, o in zip(held_bytes(state.params),
                                      held_bytes(state.opt_state))]
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    history, pending = [], []
    # a ZeRO-1 process that holds fewer rows than the axis gathers every
    # rank's to rank 0 on a save (a collective: every process saves)
    transport = step_fn.transport
    gather = (step_fn.zero_opt_active
              and len(transport.ranks) < transport.axis_size)

    def _save(at: int, wait: bool = False):
        tree = state
        if gather:
            tree = dataclasses.replace(
                state, opt_state=gather_rows(state.opt_state, transport))
        if placed and process_mesh:
            # the whole leaves are gathered on every process (a collective)
            tree = flatten_tree(state)
        if ckpt:
            ckpt.save(at, tree, meta=data.state(at))
            if wait:
                ckpt.wait()

    def _drain():
        """One host sync for the whole pending window (the step loop never
        blocks on metrics)."""
        for step, m, n in pending:
            h = {k: float(v) for k, v in m.items()}
            h["step"] = step
            h["launches"] = n["dps_quantize"] + n["dps_quantize_onchip_prng"]
            h["kernel_launches"] = n
            history.append(h)
        pending.clear()

    # graceful pre-emption: the handler only sets a flag; the loop
    # checkpoints on the way down and exits 0 (eviction is not a failure)
    stop = {"sig": None}
    old_handlers = {}
    if main_thread:
        old_handlers = {
            s: signal.signal(s, lambda signum, frame: stop.update(sig=signum))
            for s in (signal.SIGTERM, signal.SIGINT)}

    def _signalled():
        """The pending signal; under torchrun every rank leaves at the step
        any rank was signalled (one all-reduce a step)."""
        sig = stop["sig"] or 0
        if world > 1:
            import torch.distributed as dist
            flag = torch.tensor([sig], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            sig = int(flag)
        return sig or None

    # rollback ring: (step, host snapshot) of the last K healthy states,
    # refreshed at log points
    ring = deque(maxlen=max(args.rollback_ring, 1))
    loss_hist = deque(maxlen=256)   # healthy drained losses (median filter)
    rollbacks = 0
    t_first = None
    in_step = False
    t0 = time.perf_counter()
    try:
        step = start
        while step < args.steps:
            sig = _signalled()
            if sig is not None:
                if args.ckpt_dir:
                    _save(step, wait=True)
                _drain()
                if rank0:
                    print(f"PREEMPTED: signal {sig} (checkpointed at step "
                          f"{step}); exiting cleanly", flush=True)
                return {"preempted_at": step, "history": history,
                        "ckpt_saves": ckpt.records if ckpt else [],
                        "resumed": resumed}
            before = launch_counts()
            in_step = True
            ts = time.perf_counter()
            state, metrics = step_fn(state, data.batch(step))
            if args.step_timeout and cuda:
                # the watchdog needs the step's real time: one device sync
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - ts
            in_step = False
            pending.append((step, metrics, {k: v - before[k] for k, v in
                                            launch_counts().items()}))
            if on_step is not None:
                on_step(step, state)
            if t_first is None:
                if cuda:
                    torch.cuda.synchronize(device)
                t_first = time.perf_counter()
            if args.step_timeout and dt > args.step_timeout and step > start:
                raise TimeoutError(f"step {step} took {dt:.1f}s > "
                                   f"{args.step_timeout}s (straggler "
                                   "watchdog)")
            if step % args.log_every == 0 or step == args.steps - 1:
                window_at = len(history)
                _drain()
                window = history[window_at:]
                m = history[-1]
                wire = ""
                if "E_wire" in m:
                    wire = (f" E_wire {m['E_wire']:.2e} R_wire "
                            f"{m['R_wire']:.2e}")
                moe = (f"aux {m['aux_loss']:.4f} " if "aux_loss" in m
                       else "")
                if rank0:
                    print(f"step {step:5d} loss {m['loss']:8.4f} {moe}"
                          f"w<{m['il_w']:.0f},{m['fl_w']:.0f}> "
                          f"a<{m['il_a']:.0f},{m['fl_a']:.0f}> "
                          f"g<{m['il_g']:.0f},{m['fl_g']:.0f}> {_wire_log(m)}"
                          f"E_a {m['E_a']:.2e} R_a {m['R_a']:.2e}{wire}"
                          f"{_health_log(m)}", flush=True)
                if args.rollback_ring:
                    losses = [h["loss"] for h in window]
                    bad = any(not np.isfinite(v) for v in losses)
                    med = (float(np.median(loss_hist))
                           if len(loss_hist) >= 4 else None)
                    spiked = bad or (med is not None and med > 0
                                     and max(losses) > args.rollback_spike
                                     * med)
                    if spiked and ring and rollbacks < 8:
                        snap_step, snap = ring[-1]
                        _roll_back(state, snap, placed)
                        _force_degrade(state, args.guard_cooldown)
                        rollbacks += 1
                        if rank0:
                            print(f"ROLLBACK: loss spike at step {step} "
                                  f"(median {med}), resuming from step "
                                  f"{snap_step} with wire degraded",
                                  flush=True)
                        step = snap_step
                        continue
                    if not spiked:
                        loss_hist.extend(losses)
                        ring.append((step + 1, _snapshot(state, placed)))
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                _save(step + 1)
            if args.fail_at and step + 1 >= args.fail_at:
                raise RuntimeError(f"injected failure at step {step + 1}")
            if (args.sigterm_at and step + 1 >= args.sigterm_at
                    and stop["sig"] is None):
                # pre-emption drill: a real SIGTERM to this process; the
                # handler and the loop top take it from here
                os.kill(os.getpid(), signal.SIGTERM)
            step += 1
        if cuda:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        if args.ckpt_dir:
            _save(args.steps, wait=True)
    except (TimeoutError, RuntimeError) as e:
        # crash path: persist progress, then exit 17 (a FAILURE, unlike the
        # pre-emption's 0).  The step updates the state in place, so a step
        # that died midway leaves nothing consistent to save.
        if in_step:
            note = "not checkpointed: the step died midway"
        else:
            note = f"checkpointed at step {state.step}"
            if args.ckpt_dir:
                _save(state.step, wait=True)
        if rank0:
            print(f"ABORT: {e} ({note})", flush=True)
        raise SystemExit(17)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if ckpt:
            ckpt.wait()
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
    _drain()
    rest = args.steps - start - 1
    wire_kernels = ("dps_quant_wire", "dps_quant_wire_onchip_prng",
                    "dps_wire_reduce", "dps_group_wire_encode",
                    "dps_group_wire_encode_onchip_prng")
    out = {"final_loss": history[-1]["loss"] if history else None,
           "history_tail": history[-5:],
           "device": (torch.cuda.get_device_name(device) if cuda
                      else "cpu"),
           "params": cfg.n_params(),
           "data_ranks": step_fn.n_data,
           "mesh": (None if mesh is None else
                    dict(zip(*((mesh.mesh_dim_names,
                                tuple(mesh.mesh.shape))
                               if hasattr(mesh, "mesh_dim_names")
                               else (mesh.axis_names, mesh.shape))))),
           "held_bytes_per_rank": held if placed else None,
           "wire_sync": step_fn.wire_sync_active,
           "zero_opt": step_fn.zero_opt_active,
           "zero_groupaligned": step_fn.zero_groupaligned_active,
           "wire_overlap": step_fn.wire_overlap_active,
           "wire_buckets": step_fn.wire_buckets,
           "guards": step_fn.guards_active,
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
           "aux_loss": history[-1].get("aux_loss") if history else None,
           "E_wire": history[-1].get("E_wire") if history else None,
           "R_wire": history[-1].get("R_wire") if history else None,
           "resumed": resumed,
           "rollbacks": rollbacks,
           "ckpt_saves": ckpt.records if ckpt else []}
    if rank0:
        print(json.dumps(out, indent=1))
    out["history"] = history
    return out


if __name__ == "__main__":
    main()
