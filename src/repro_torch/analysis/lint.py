"""Precision-flow lint: the three analysis passes over a config grid.

    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu
    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu \\
        --config llama3_2_3b --modes tree,zero-per-layer
    PYTHONPATH=src python -m repro_torch.analysis.lint --guards

Counterpart of ``repro/analysis/lint.py``, with its cells, modes and flags.
Each cell builds a REAL train step (the constructors the launch and test
code use: ``qtrain.make_train_step``, ``launch.specs.build_train_step``) on
a stacked data mesh of ``--ranks`` ranks (8 by default, the reference's
forced host devices), runs ONE step of it under a
:class:`~repro_torch.analysis.trace.Trace`, and proves the wire invariants
on what ran, three ways: dataflow over the trace
(:mod:`~repro_torch.analysis.flow`), the byte and dtype audit of its
collectives (:mod:`~repro_torch.analysis.trace_audit`, reports named
``/trace`` where the reference's are ``/hlo``), and the geometry of the
kernel launches the cell's layouts imply
(:mod:`~repro_torch.analysis.kernel_checks`).  On the card (``--device
cuda``, the default) the step runs the kernels, and every launch the trace
recorded is checked too against the card's properties
(``/kernel/launches``).  Exits nonzero on any violation.

The modes are the reference's: ``baseline`` (no wire), ``tree`` (the
global-format int8 all-reduce), ``per-layer`` (one wire ⟨IL, FL⟩ a leaf),
``zero`` (ZeRO-1 over the plain flat layout), ``zero-per-layer`` (ZeRO-1
over the group-aligned layout), ``zero-overlap`` (ZeRO-1 with the
backward-overlapped bucketed wire) and ``serve-decode`` (an admission and
a paged decode step of the serving engine at smoke size; its kernels'
geometry at production dims).  ``--wire-overlap on`` rebuilds ``tree`` and
``per-layer`` with the bucketed wire.  Arch configs run at
``configs.base.smoke`` size: the wire schedule does not depend on depth or
width.

``--guards`` arms the health guards in every train cell.  XLA compiles
both branches of a guarded wire, so the reference admits the fp32 fallback's
bytes as declared capacity; an eager step runs one branch, so the port
audits the clean step against the int8 claims and then a degraded step — a
NaN drill trips the guards, and the next step runs the fallback — against
its own claims (``/degraded/...`` reports).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from repro_torch.analysis import flow, kernel_checks, trace_audit
from repro_torch.analysis.report import Report
from repro_torch.analysis.trace import Trace
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.dist import collectives
from repro_torch.dist.transport import StackedTransport
from repro_torch.kernels import ops
from repro_torch.launch.trace_stats import collective_wire_bytes

MODES = ("baseline", "tree", "per-layer", "zero", "zero-per-layer",
         "zero-overlap", "serve-decode")
DEFAULT_RANKS = 8


def _mode_qcfg(mode: str, n_ranks: int, wire_controller: str,
               wire_overlap: bool = False,
               guards: bool = False) -> qtrain.QuantConfig:
    kw = dict(enabled=True, controller="paper",
              wire_controller=wire_controller)
    if mode in ("tree", "per-layer"):
        kw["grad_allreduce_bits"] = 8
        kw["wire_overlap"] = wire_overlap
    elif mode in ("zero", "zero-per-layer", "zero-overlap"):
        kw["grad_allreduce_bits"] = 8
        kw["zero_opt_shards"] = n_ranks
        kw["wire_overlap"] = mode == "zero-overlap"
    if guards:
        from repro_torch.resilience import GuardConfig
        kw["guards"] = GuardConfig()
    return qtrain.QuantConfig(**kw)


def _claims(qcfg: qtrain.QuantConfig, transport, params, n_params: int,
            degraded=()) -> trace_audit.AuditClaims:
    """The reference's claims for the step this config runs on
    ``transport``; ``degraded``: the wire domains whose legs run their fp32
    fallback this step (the guards' degrade branch)."""
    engaged: List[str] = []
    two_leg = True
    declared_f32 = 0.0
    n_wire = n_params
    if qtrain.wire_sync_engaged(qcfg, transport):
        engaged.append("wire_grads")
    if qtrain.zero_opt_engaged(qcfg, transport):
        engaged.append("wire_grads")
        # both sharded legs ship the flat layout's padded element count
        part = qtrain.zero_partitioner(qcfg, params, qcfg.zero_opt_shards)
        n_wire = part.padded_size
        if qtrain.wire_params_engaged(qcfg, params, transport):
            engaged.append("wire_params")
        else:
            # the policy excludes leaves: the params leg runs fp32 BY
            # DESIGN — one declared fp32 gather, one int8 leg
            two_leg = False
            declared_f32 = 4.0 * part.padded_size * 1.25
    engaged = list(dict.fromkeys(engaged))
    fallback = tuple(d for d in engaged if d in degraded)
    if fallback:
        # the fallback's exact fp32 legs (ring model: an all-reduce counts
        # twice its payload; ZeRO's reduce-scatter and gather once each);
        # what stays on the wire is one leg at most
        engaged = [d for d in engaged if d not in fallback]
        two_leg = False
        declared_f32 += 2.0 * 4.0 * n_wire * 1.25
    return trace_audit.AuditClaims(
        engaged=tuple(engaged), fallback=fallback, two_leg=two_leg,
        grouped=False, f32_declared_bytes=declared_f32,
        n_wire_elems=n_wire if engaged or fallback else None)


def _layouts(mode: str, qcfg, params, leaf_sizes, n: int,
             wire_overlap: bool):
    """The wire layouts the cell's step builds, and whether they are
    grouped (a format table read through a tile map)."""
    from repro_torch.dist import overlap as overlap_lib
    total = sum(leaf_sizes)
    if mode.startswith("zero"):
        part = qtrain.zero_partitioner(qcfg, params, n)
        if hasattr(part, "layouts"):
            return list(part.layouts), True
        # the plain partitioner: the leaves packed into rank chunks of
        # ``shard_size`` elements, one format
        return [collectives.group_layout((total,), n_chunks=n,
                                         quantum=part.shard_size)], False
    # the all-reduce: one collective, or one a bucket of the overlapped
    # wire; per-leaf formats run the group-aligned layout, one format packs
    # the leaves into rank chunks rounded to 16 elements
    runs = [tuple(range(len(leaf_sizes)))]
    if wire_overlap:
        runs = sorted(overlap_lib.plan_buckets(
            leaf_sizes, qcfg.wire_bucket_elems
            or overlap_lib.DEFAULT_BUCKET_ELEMS).buckets)
    grouped = mode == "per-layer"
    out = []
    for run in runs:
        sizes = [leaf_sizes[g] for g in run]
        if grouped:
            q = collectives.default_wire_quantum(sum(sizes), len(sizes))
            out.append(collectives.group_layout(sizes, n_chunks=n, quantum=q))
        else:
            chunk = collectives._rank_chunk(sum(sizes), n)
            out.append(collectives.group_layout((sum(sizes),), n_chunks=n,
                                                quantum=chunk))
    return out, grouped


def _kernel_reports(mode: str, qcfg, params, leaf_sizes, n: int, name: str,
                    wire_overlap: bool = False) -> List[Report]:
    """The geometry of the launches this cell's wire runs, derived from its
    layouts (the K3/K4 tiling is provable anywhere): the layouts, the
    encodes (K3 over an aligned layout; K2 a leaf into a packed one) and
    the K4 decode-reduces."""
    layouts, grouped = _layouts(mode, qcfg, params, leaf_sizes, n,
                                wire_overlap)
    lay_rep = Report(name=f"{name}/layout")
    enc = Report(name=f"{name}/encode")
    red = Report(name=f"{name}/reduce")
    start = 0
    for lay in layouts:
        lay_rep.merge(kernel_checks.check_layout(lay, name=lay_rep.name))
        G = len(lay.group_sizes)
        if grouped:
            enc.merge(kernel_checks.check_call(
                ops.group_wire_call_geometry(lay.total, G, lay.quantum),
                expected_groups=G, name=enc.name))
            red.merge(kernel_checks.check_call(
                ops.wire_reduce_call_geometry(n, lay.chunk, G, lay.quantum),
                expected_groups=G, name=red.name))
        else:
            # K2 on each leaf of the packed run (the run's leaves are the
            # next ones in flatten order, summing to the layout's size)
            stop, acc = start, 0
            while acc < lay.size:
                acc += leaf_sizes[stop]
                stop += 1
            for size in leaf_sizes[start:stop]:
                enc.merge(kernel_checks.check_call(
                    ops.quantize_call_geometry(size, wire=True),
                    name=enc.name))
            start = stop
            red.merge(kernel_checks.check_call(
                ops.wire_reduce_call_geometry(n, lay.chunk, 1, None),
                expected_groups=1, name=red.name))
    return [lay_rep, enc, red]


def _wire_pipeline_report(mode: str, leaf_sizes, transport, device,
                          name: str, wire_overlap: bool = False) -> Report:
    """The wire pipeline run on its own (the reference's
    ``bench_collectives`` idiom): a tree all-reduce over gradient-shaped
    leaves.  Only here is the zero-fp32-concat claim checkable — a model
    step concatenates fp32 activations freely."""
    from repro_torch.core.fixed_point import FixedPointFormat
    from repro_torch.dist import overlap as overlap_lib

    groups = len(leaf_sizes) if mode == "per-layer" else 1
    shape = (groups,) if mode == "per-layer" else ()
    fmt = FixedPointFormat(torch.full(shape, 3, dtype=torch.int32,
                                      device=device),
                           torch.full(shape, 5, dtype=torch.int32,
                                      device=device))
    gen = torch.Generator(device=device).manual_seed(1)
    trees = [{f"leaf{i}": torch.randn(s, generator=gen, device=device)
              for i, s in enumerate(leaf_sizes)} for _ in transport.ranks]
    fn = (overlap_lib.bucketed_allreduce_mean_tree if wire_overlap
          else collectives.dps_allreduce_mean_tree)
    with Trace() as tr:
        fn(trees, fmt, transport, 1)
    claims = trace_audit.AuditClaims(
        engaged=("wire_grads",), two_leg=True, grouped=True,
        f32_concat_budget=64.0 * groups, n_wire_elems=sum(leaf_sizes))
    return trace_audit.audit_trace(tr, claims, name=name)


def _step_reports(make_step, state, batch, qcfg, transport, mode: str,
                  params, leaf_sizes, name: str, device,
                  wire_overlap: bool = False,
                  wire_bytes: Optional[dict] = None) -> List[Report]:
    """One step of ``make_step()`` recorded and checked; with the guards
    armed, then the NaN drill's degraded step (``make_step(faults)``).
    ``wire_bytes``: receives the step's ring-model collective bytes under
    ``name``."""
    n_params = sum(leaf_sizes)
    step = make_step()
    with Trace() as tr:
        state, _ = step(state, batch)
    if wire_bytes is not None:
        wire_bytes[name] = collective_wire_bytes(tr)
    reports = [flow.analyze_trace(tr, name=f"{name}/flow")]
    claims = _claims(qcfg, transport, params, n_params)
    reports.append(trace_audit.audit_trace(tr, claims, name=f"{name}/trace"))
    if claims.engaged:
        if mode in ("tree", "per-layer"):
            reports.append(_wire_pipeline_report(
                mode, leaf_sizes, transport, device, f"{name}/pipeline",
                wire_overlap))
        reports.extend(_kernel_reports(mode, qcfg, params, leaf_sizes,
                                       transport.axis_size, f"{name}/kernel",
                                       wire_overlap))
    reports.extend(_launch_reports(tr, device, f"{name}/kernel/launches"))
    tr.release()
    if qcfg.guards is not None and claims.engaged:
        reports.extend(_degraded_reports(make_step, state, batch, qcfg,
                                         transport, params, n_params, name))
    return reports


def _launch_reports(tr, device, name: str) -> List[Report]:
    """On the card: every launch the trace recorded, against the library's
    signatures and the card's shared memory."""
    if torch.device(device).type != "cuda":
        return []
    return [kernel_checks.check_launches(
        tr, name=name,
        smem_budget=kernel_checks.device_smem_budget(torch.device(device)))]


def _degraded_reports(make_step, state, batch, qcfg, transport, params,
                      n_params: int, name: str) -> List[Report]:
    """The NaN drill: NaN gradients on one step trip the guards, so the
    next step runs every engaged leg's fp32 fallback; that step is audited
    against the fallback's claims."""
    from repro_torch.resilience import FaultPlan, wire_domains
    drill = make_step(FaultPlan(nan_grads_at=state.step))
    state, _ = drill(state, batch)
    flags = state.guard.degraded.tolist()
    degraded = {d for d, f in zip(wire_domains(qcfg.plan()), flags) if f}
    if not degraded:
        r = Report(name=f"{name}/degraded")
        r.add("HA-DOMAIN-COVERAGE", "the NaN drill did not trip the guards: "
              "no degraded step to audit", name)
        return [r]
    with Trace() as tr:
        drill(state, batch)
    claims = _claims(qcfg, transport, params, n_params, degraded=degraded)
    return [flow.analyze_trace(tr, name=f"{name}/degraded/flow"),
            trace_audit.audit_trace(tr, claims,
                                    name=f"{name}/degraded/trace")]


def _lenet_cell(mode: str, n: int, device, wire_controller: str,
                wire_overlap: bool = False, guards: bool = False,
                wire_bytes: Optional[dict] = None) -> List[Report]:
    from repro_torch.models import lenet
    from repro_torch.optim import SGDConfig, make_optimizer

    transport = StackedTransport(n, device)
    qcfg = _mode_qcfg(mode, n, wire_controller, wire_overlap, guards)
    params = lenet.init(0, device)
    if "per-layer" in mode:
        qcfg = qcfg.with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig())
    opt_state = (qtrain.zero_opt_state(opt, params, transport, qcfg=qcfg)
                 if mode.startswith("zero") else opt.init(params))
    state = qtrain.TrainState.create(params, opt_state, qcfg, 1)
    batch = {"images": torch.zeros((2 * n, 28, 28, 1), device=device),
             "labels": torch.zeros((2 * n,), dtype=torch.int64,
                                   device=device)}
    def make_step(faults=None):
        return qtrain.make_train_step(lenet.loss_fn, opt, qcfg,
                                      transport=transport, faults=faults)
    leaf_sizes = [l.numel() for l in tree_lib.leaves(params)]
    return _step_reports(make_step, state, batch, qcfg, transport, mode,
                         params, leaf_sizes, f"lenet/{mode}", device,
                         wire_overlap, wire_bytes)


def _arch_cell(arch: str, mode: str, n: int, device, wire_controller: str,
               seq: int, wire_overlap: bool = False, guards: bool = False,
               wire_bytes: Optional[dict] = None) -> List[Report]:
    from repro_torch.configs.base import get_config, smoke
    from repro_torch.dist.sharding import StackedMesh
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.optim import SGDConfig, make_optimizer

    cfg = smoke(get_config(arch))
    mesh = StackedMesh((n,), ("data",), device)
    transport = mesh.transport("data")
    qcfg = _mode_qcfg(mode, n, wire_controller, wire_overlap, guards)
    if "per-layer" in mode:
        qcfg = specs_lib.per_layer_wire_qcfg(cfg, qcfg)
    opt = make_optimizer(SGDConfig())
    mod = registry(cfg.family)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(mod.model_defs(cfg), device, gen)
    opt_state = (qtrain.zero_opt_state(opt, params, transport, qcfg=qcfg)
                 if mode.startswith("zero") else opt.init(params))
    state = qtrain.TrainState.create(params, opt_state, qcfg, 1)
    def make_step(faults=None):
        return specs_lib.build_train_step(cfg, qcfg, opt, accum_steps=1,
                                          mesh=mesh, faults=faults)
    batch = {"tokens": torch.zeros((n, seq), dtype=torch.int64,
                                   device=device)}
    leaf_sizes = [l.numel() for l in tree_lib.leaves(params)]
    return _step_reports(make_step, state, batch, qcfg, transport, mode,
                         params, leaf_sizes, f"{arch}/{mode}", device,
                         wire_overlap, wire_bytes)


# production serving dims of the kernel-geometry half of the serve cell
# (the reference's): 8 rows of 16 pages of 128 tokens, a 512-page pool
SERVE_PROD = dict(batch_slots=8, pages_per_seq=16, page_size=128,
                  n_pages=512)


def _serve_cell(config: str, device) -> List[Report]:
    """The serving engine at smoke size (the wire contract does not depend
    on size): one admission (the prompt's pages encoded, K3 on the card)
    and one batched paged decode step (K5), both recorded; kernel geometry
    at production dims."""
    from repro_torch.configs.base import get_config, smoke
    from repro_torch.serve import EngineConfig, PagedLayout, analysis_decode

    arch = "llama3_2_3b" if config == "lenet" else config
    cfg = smoke(get_config(arch))
    # pool sized so one stacked page pool out-counts every legitimate fp32
    # tensor of the smoke step (the reference's layout)
    lay = PagedLayout(page_size=4, n_pages=192, batch_slots=4,
                      max_pages_per_seq=8, max_prompt=16)
    ecfg = EngineConfig(layout=lay, kv_bits=8)
    name = f"{arch}/serve-decode"
    with Trace() as tr:
        fn, args = analysis_decode(cfg, ecfg, device=device)
        fn(*args)
    flow_rep = flow.analyze_trace(tr, name=f"{name}/flow")
    if "PF-KV-WIRE" not in flow_rep.checked:
        flow_rep.add("PF-KV-WIRE",
                     "decode step never tags its KV pages (kv_page "
                     "landmarks absent) — the page wire contract is "
                     "unverifiable", name)
    reports = [flow_rep]
    pool_elems = (cfg.n_layers * lay.n_pages_total * lay.page_size
                  * cfg.n_kv_heads * cfg.head_dim)
    reports.append(trace_audit.audit_decode_trace(
        tr, pool_elems=pool_elems, bits=8, name=f"{name}/trace"))

    prod = get_config(arch)
    B, P = SERVE_PROD["batch_slots"], SERVE_PROD["pages_per_seq"]
    ps, n_pages = SERVE_PROD["page_size"], SERVE_PROD["n_pages"]
    page_elems = ps * prod.n_kv_heads * prod.head_dim
    reports.append(kernel_checks.check_call(
        ops.paged_attn_call_geometry(B, P, n_pages + 1, ps, prod.n_kv_heads,
                                     prod.head_dim, prod.n_heads),
        expected_groups=n_pages + 1, name=f"{name}/attn-kernel"))
    groups = 2 * prod.n_layers * (P // 2)   # one admission's page encode
    reports.append(kernel_checks.check_call(
        ops.group_wire_call_geometry(groups * page_elems, groups,
                                     page_elems),
        expected_groups=groups, name=f"{name}/encode-kernel"))
    reports.extend(_launch_reports(tr, device, f"{name}/launches"))
    tr.release()
    return reports


def lint_cell(config: str, mode: str, n_ranks: int = DEFAULT_RANKS,
              device="cuda", wire_controller: str = "flexpoint",
              seq: int = 16, wire_overlap: bool = False,
              guards: bool = False,
              wire_bytes: Optional[dict] = None) -> List[Report]:
    """All three passes over one (config, mode) cell; returns Reports.
    ``wire_bytes`` (a dict): receives each train step's ring-model
    collective bytes (:func:`~repro_torch.launch.trace_stats.
    collective_wire_bytes`) under the cell's name.  ``device``: the card
    (the kernels, every recorded launch checked) unless ``"cpu"`` is asked
    for (the plain versions)."""
    device = resolve_device(device)
    if mode == "serve-decode":
        return _serve_cell(config, device)
    if config == "lenet":
        return _lenet_cell(mode, n_ranks, device, wire_controller,
                           wire_overlap, guards, wire_bytes)
    return _arch_cell(config, mode, n_ranks, device, wire_controller, seq,
                      wire_overlap, guards, wire_bytes)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Verify the wire invariants of the port's steps on a "
                    "recorded run (see src/repro_torch/analysis/README.md).")
    ap.add_argument("--config", action="append", default=None,
                    help="config to lint: 'lenet' (default) or an arch "
                         "name from repro_torch.configs.base (repeatable)")
    ap.add_argument("--zero-opt", action="store_true",
                    help="lint only the ZeRO-1 cell (composes with "
                         "--wire-groups per-layer / --wire-overlap on)")
    ap.add_argument("--wire-groups", choices=("global", "per-layer"),
                    default=None,
                    help="lint only the tree (global) or per-layer cell")
    ap.add_argument("--modes", default=None,
                    help=f"comma-separated subset of {MODES}")
    ap.add_argument("--wire-controller", default="flexpoint")
    ap.add_argument("--wire-overlap", choices=("on", "off"), default="off",
                    help="rebuild the tree/per-layer cells with the "
                         "backward-overlapped bucketed wire")
    ap.add_argument("--guards", action="store_true",
                    help="arm the health guards in every train cell: the "
                         "flow pass proves PF-GUARD-TAINT, and a NaN "
                         "drill's degraded step is audited on its own")
    ap.add_argument("--seq", type=int, default=16,
                    help="sequence length of the arch train cells")
    ap.add_argument("--ranks", type=int, default=DEFAULT_RANKS,
                    help="ranks of the stacked data mesh")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.zero_opt:
        if args.wire_groups == "per-layer":
            modes = ["zero-per-layer"]
        elif args.wire_overlap == "on":
            modes = ["zero-overlap"]
        else:
            modes = ["zero"]
    elif args.wire_groups is not None:
        modes = ["per-layer" if args.wire_groups == "per-layer" else "tree"]
    elif args.modes:
        modes = [m.strip() for m in args.modes.split(",")]
    else:
        modes = list(MODES)
    for m in modes:
        if m not in MODES:
            ap.error(f"unknown mode {m!r} (choose from {MODES})")
    device = resolve_device(args.device)
    configs = args.config or ["lenet"]

    print(f"precision-flow lint: {args.ranks} stacked rank(s) on {device}, "
          f"configs={configs}, modes={modes}", flush=True)
    n_viol = 0
    for config in configs:
        for mode in modes:
            try:
                reports = lint_cell(config, mode, args.ranks, device,
                                    args.wire_controller, args.seq,
                                    args.wire_overlap == "on", args.guards)
            except Exception as e:          # a cell that cannot build IS a
                n_viol += 1                 # lint failure, not a skip
                print(f"ERROR {config}/{mode}: {e!r}", flush=True)
                continue
            for r in reports:
                print(f"  {r.summary()}", flush=True)
                n_viol += len(r.violations)
    print(f"precision-flow lint: "
          f"{'CLEAN' if not n_viol else f'{n_viol} violation(s)'}",
          flush=True)
    return 1 if n_viol else 0


if __name__ == "__main__":
    sys.exit(main())
