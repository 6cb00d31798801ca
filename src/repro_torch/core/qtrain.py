"""Quantized-training plumbing: taps, precision-domain registry, train state.

Counterpart of ``repro/core/qtrain.py``: the replicated step, the
int8-wire data-parallel step (``QuantConfig.grad_allreduce_bits`` with a
transport of more than one rank), its backward-overlapped bucketed form
(``wire_overlap``) and ZeRO-1 (``zero_opt_shards``: the optimizer state
sharded over the data axis), and the health guards with their fault
injection (``guards``, ``make_train_step(faults=...)``: see
:mod:`repro_torch.resilience.guards`) on every one of those steps and on
the placed step (:func:`make_placed_train_step`).  Wires
the paper's Algorithm 1 into a PyTorch model:

  forward pass   — activations pass through :meth:`QCtx.tap` (quantize +
                   stats on the way down, the cotangent quantized on the way
                   back up, by :class:`_QTap`),
  backward pass  — parameter gradients are quantized before the optimizer;
                   the loss's own logit gradient is quantized for its stats,
  weight update  — updated weights are re-snapped to the weight grid,
  scale_precision — one controller per precision domain consumes the step's
                   merged stats and emits the next step's ⟨IL, FL⟩.

Every quantization event is one launch of the fused quantizer
(:func:`repro_torch.kernels.ops.dps_quantize`): K1b (Philox bits made in
the kernel) when ``QuantConfig.onchip_prng``, else K1 with a bits operand
drawn by ``torch.randint``; on the CPU their plain versions.  Each event's
64-bit seed is :func:`~repro_torch.core.fixed_point.fold_seed` of (run
seed, step, domain, salt) — host integers, so a recomputed forward (full
remat) draws the same bits, and no step reads a device value: ⟨IL, FL⟩
stay on the device from controller to kernel.

The parameters, optimizer state and the state's parameter tree are updated
**in place** (see :mod:`repro_torch.optim.optimizers`): the step returns
the same :class:`TrainState` object, advanced.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.core import dps as dps_lib
from repro_torch.core import fixed_point as fxp
from repro_torch.core import tagging
from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DpsBundle, DomainSpec, PrecisionPlan
from repro_torch.core.fixed_point import FixedPointFormat, QuantStats, fold_seed
from repro_torch.core.policy import QuantPolicy
from repro_torch.dist import sharding
from repro_torch.dist.sharding import is_placed
from repro_torch.kernels import ops, ref as ref_lib

# the wire path's stream salt ("WIRE"), as the reference folds its key
_WIRE_SALT = 0x57495245


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the quantized-training scheme."""

    enabled: bool = True
    controller: str = "paper"
    rounding: str = fxp.ROUND_STOCHASTIC
    policy: QuantPolicy = QuantPolicy()
    # one hyper per compute domain; the paper runs one Alg.-2 instance each
    # for weights, activations and gradients (global granularity)
    hyper_weights: dps_lib.DPSHyper = dps_lib.DPSHyper()
    hyper_acts: dps_lib.DPSHyper = dps_lib.DPSHyper()
    hyper_grads: dps_lib.DPSHyper = dps_lib.DPSHyper(il_init=8, fl_init=16)
    stat_scope: str = "global"          # "global" | "last_layer"
    # keep the parameters as they are after the update, off the weight
    # grid (beyond the paper): every step body skips the re-snap of
    # Alg. 1 line 19, and ZeRO-1's parameter all-gather stays fp32
    master_weights: bool = False
    # Stochastic-rounding bits: drawn inside the quantizer kernel (K1b, the
    # reference's use_onchip_prng=True) or drawn with torch.randint and
    # handed to it as an operand (K1, the reference's default).  The int8
    # wire takes the same source: K2b/K3b, or K2/K3 with an operand.
    onchip_prng: bool = True
    # Quantizer backend: "auto" (kernel on CUDA tensors, plain version on
    # CPU tensors), "kernel", or "plain" (to hold the kernel to its plain
    # version on the card).
    backend: str = "auto"
    # Wire precision domain: with compressed gradient sync on, the int8
    # gradient all-reduce runs its own controller ("wire_grads") instead of
    # deriving ⟨IL, 8−IL⟩ from a compute controller.  "flexpoint" places the
    # wire radix just above the observed max |x| at a fixed wire width.
    wire_controller: str = "flexpoint"
    hyper_wire_grads: Optional[dps_lib.DPSHyper] = None   # None -> derived
    # Measured wire slack (dps.wire_hyper(auto_slack=True)); only affects
    # the derived hyper — an explicit hyper_wire_grads wins.
    wire_auto_slack: bool = False
    # Per-LAYER wire formats: 0 = one global wire ⟨IL, FL⟩; G > 0 gives
    # ``wire_grads`` a [G] controller state, one ⟨IL, FL⟩ per gradient leaf
    # (the [G, 2] table of the group-aligned collectives).  G must equal the
    # gradient tree's leaf count; ``with_per_layer_wire`` derives it.
    wire_grads_groups: int = 0
    # Opt-in compressed gradient synchronization: with a transport of more
    # than one rank (make_train_step(..., transport=...)), each rank's
    # gradients are averaged by the int8-wire tree all-reduce
    # (repro_torch.dist.collectives) instead of an fp32 one; its dispatch-leg
    # stats feed the wire_grads domain.  2..8 grid bits.
    grad_allreduce_bits: Optional[int] = None
    # the params leg's hyper under ZeRO-1 (None -> derived: radix over the
    # max with headroom, slack +1)
    hyper_wire_params: Optional[dps_lib.DPSHyper] = None
    # ZeRO-1: shard the optimizer state over the data axis in this many
    # flat slices (must equal the transport's axis size to engage; a
    # mismatch warns and falls back to the replicated state).  The flat
    # layout is zero_partitioner's; the state comes from zero_opt_state.
    # With grad_allreduce_bits the gradients reach each owner through the
    # int8 reduce-scatter and, when the policy quantizes every leaf, the
    # updated parameters come back through the int8 wire_params all-gather.
    zero_opt_shards: Optional[int] = None
    # Backward-overlapped bucketed wire (repro_torch.dist.overlap): one
    # compressed collective per bucket of about wire_bucket_elems elements
    # (None -> DEFAULT_BUCKET_ELEMS), each issued as soon as the backward
    # has produced its gradients.  Engages with the compressed sync only.
    wire_overlap: bool = False
    wire_bucket_elems: Optional[int] = None
    # Health guards (repro_torch.resilience.GuardConfig): in-step NaN,
    # overflow-storm and spike detection, the skip gate, and the int8 wire's
    # fp32 fallback (each leg of ZeRO-1's on its own).
    guards: Optional[Any] = None
    # A full custom registry: replaces the plan built from the fields
    # above (its domains, controllers, hypers and groups), whole.
    precision_plan: Optional[PrecisionPlan] = None

    def __post_init__(self):
        if self.backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown quantizer backend {self.backend!r}")

    def plan(self) -> PrecisionPlan:
        """The precision-domain registry this config trains under: one
        domain per compute attribute, plus ``wire_grads`` whenever
        ``grad_allreduce_bits`` is set (gradients start wide, ±2^5, and
        track the bulk two octaves under the max: slack −2), and
        ``wire_params`` when ZeRO-1 can put the parameter all-gather on the
        wire too (parameters are O(1): the radix covers the max, slack +1;
        one format per leaf like ``wire_grads``).  A custom
        ``precision_plan`` replaces all of it."""
        if self.precision_plan is not None:
            return self.precision_plan
        domains = [
            ("weights", DomainSpec(self.controller, self.hyper_weights)),
            ("acts", DomainSpec(self.controller, self.hyper_acts)),
            ("grads", DomainSpec(self.controller, self.hyper_grads)),
        ]
        wb = self.grad_allreduce_bits
        if wb is not None:
            domains.append(("wire_grads", DomainSpec(
                self.wire_controller,
                self.hyper_wire_grads
                or dps_lib.wire_hyper(wb, il_init=6, slack=-2.0,
                                      auto_slack=self.wire_auto_slack),
                groups=self.wire_grads_groups, wire=True)))
            if self.zero_opt_shards is not None:
                domains.append(("wire_params", DomainSpec(
                    self.wire_controller,
                    self.hyper_wire_params
                    or dps_lib.wire_hyper(wb, il_init=2, slack=1.0,
                                          auto_slack=self.wire_auto_slack),
                    groups=self.wire_grads_groups, wire=True)))
        return PrecisionPlan(tuple(domains))

    def with_per_layer_wire(self, params) -> "QuantConfig":
        """This config with one ``wire_grads`` format per leaf of
        ``params`` (a tree of tensors or of anything with the same leaves).
        A no-op unless ``grad_allreduce_bits`` is set, and under a custom
        ``precision_plan`` (its groups are its own)."""
        if self.grad_allreduce_bits is None or self.precision_plan is not None:
            return self
        return dataclasses.replace(
            self, wire_grads_groups=len(tree_lib.leaves(params)))


def init_dps_bundle(qcfg: QuantConfig, device=None) -> DpsBundle:
    """Initial DPS registry: one controller state per declared domain."""
    return qcfg.plan().init(device)


def dps_restore_defaults(qcfg: QuantConfig, prefix: str = ".dps") -> dict:
    """Checkpoint defaults: a fresh DPS registry flattened to the
    checkpoint's ``".dps/<domain>/.<field>"`` keys, for
    ``checkpoint.restore(..., defaults=...)`` — a run whose plan declares
    domains a checkpoint lacks (e.g. ``wire_grads``) starts those fresh."""
    from repro_torch.checkpoint import flatten_tree   # checkpoint imports core
    return {f"{prefix}/{k}": v
            for k, v in flatten_tree(init_dps_bundle(qcfg)).items()}


def guard_restore_defaults(qcfg: QuantConfig, prefix: str = ".guard") -> dict:
    """Checkpoint defaults for the guard subtree: a guarded run resumes
    from a checkpoint written without guards.  Empty when guards are off."""
    if qcfg.guards is None:
        return {}
    from repro_torch.resilience import guards as guards_lib
    return guards_lib.guard_restore_defaults(qcfg.plan(), prefix)


def bundle_formats(qcfg: QuantConfig, bundle: DpsBundle
                   ) -> Dict[str, FixedPointFormat]:
    """Per-domain ⟨IL, FL⟩ for this step, keyed by domain name."""
    return qcfg.plan().formats(bundle)


def update_dps_bundle(qcfg: QuantConfig, bundle: DpsBundle,
                      streams: Dict[str, QuantStats], aux=None) -> DpsBundle:
    """scale_precision over the registry: each domain consumes the stats
    stream its spec routes to (absent streams read as zero stats)."""
    return qcfg.plan().update(bundle, streams, aux)


# ---------------------------------------------------------------------------
# Activation tap: quantize forward, quantize the cotangent backward.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QCtx:
    """Per-step quantization context handed to model code (``None``
    disables taps; model code guards with ``if qctx is not None``)."""

    acts_fmt: FixedPointFormat
    grads_fmt: FixedPointFormat
    seed: int
    rounding: str
    collect_stats: bool
    onchip_prng: bool = True
    backend: str = "auto"

    def quantize(self, x: torch.Tensor, fmt: FixedPointFormat, seed: int,
                 compute_stats: bool = True, where=None):
        """One quantization event under this context's rounding and bit
        source: ``(q, QuantStats | None)``.  ``where``: ``(shape, origin)``
        when ``x`` is the block at ``origin`` of a placed tensor of
        ``shape`` (the block rounds with the whole tensor's bits)."""
        bits = (ops.event_bits(x, self.rounding, seed, self.onchip_prng)
                if where is None else
                ops.block_event_bits(where[0], where[1], tuple(x.shape),
                                     self.rounding, seed, self.onchip_prng,
                                     x.device))
        return ops.dps_quantize(x, fmt, bits, compute_stats=compute_stats,
                                backend=self.backend)

    def tap(self, x, salt):
        """Quantize activation ``x``; returns ``(q, QuantStats | None)``.

        ``salt`` (an int or a string) decorrelates rounding noise across
        call sites; a layer stack passes the layer index.  A placed ``x``
        is tapped block by block (:meth:`_tap_placed`).
        """
        kf = fold_seed(self.seed, salt)
        kb = fold_seed(kf, 0x9E3779B9)
        if is_placed(x):
            return self._tap_placed(x, kf, kb)
        q, vec = _QTap.apply(x, self, kf, kb, None)
        return q, (ref_lib.stats_from_vector(vec) if self.collect_stats
                   else None)

    def _tap_placed(self, x, kf: int, kb: int):
        """Each held rank's block through :class:`_QTap` with the whole
        tensor's bits, the statistics merged over the split axes.  Over an
        axis ``x`` is replicated on, a rank's gradient is its share of the
        whole one: the cotangent is summed over the axis before it is
        quantized (so the gradient grid sees what the unplaced tap sees)
        and handed back in equal shares."""
        rep = x.replicated_axes()
        n_rep = math.prod(sharding._axis_sizes(x.mesh)[a] for a in rep)
        qs, vecs = [], []
        for i, b in enumerate(x.blocks):
            if rep:
                b = _GradScale.apply(b, 1.0 / n_rep)
            origin, _ = x.geometry(i)
            q, vec = _QTap.apply(b, self, kf, kb, (x.shape, origin))
            qs.append(q)
            vecs.append(vec)
        qs = sharding.psum_backward(x.mesh, rep, qs)
        out = sharding.Placed(qs, x.spec, x.mesh, x.shape)
        if not self.collect_stats:
            return out, None
        merged = fxp.merge_split_stats(vecs, x.spec, x.mesh)
        return out, ref_lib.stats_from_vector(merged[0])


class _GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _QTap(torch.autograd.Function):
    """Forward: ``x`` onto the activation grid, with statistics.  Backward:
    the cotangent onto the gradient grid, without.  The statistics come out
    as a non-differentiable ``[7]`` tensor, so a checkpointed block returns
    them instead of recording them on the side (a recompute would record
    them twice).  ``where``: see :meth:`QCtx.quantize`."""

    @staticmethod
    def forward(ctx, x, qctx: QCtx, seed_f: int, seed_b: int, where):
        q, s = qctx.quantize(x, qctx.acts_fmt, seed_f, compute_stats=True,
                             where=where)
        vec = torch.stack([s.count, s.nonzero, s.overflow, s.abs_err_sum,
                           s.rel_err_sum, s.abs_sum, s.max_abs])
        ctx.qctx, ctx.seed_b, ctx.where = qctx, seed_b, where
        ctx.mark_non_differentiable(vec)
        return q, vec

    @staticmethod
    def backward(ctx, gq, _gvec):
        qctx = ctx.qctx
        g, _ = qctx.quantize(gq.contiguous(), qctx.grads_fmt, ctx.seed_b,
                             compute_stats=False, where=ctx.where)
        return g, None, None, None, None


# ---------------------------------------------------------------------------
# Weight / gradient tree quantization.
# ---------------------------------------------------------------------------

def _quantize_tree(tree, fmt, qcfg: QuantConfig, seed: int, inplace: bool):
    return fxp.quantize_tree(tree, fmt, mode=qcfg.rounding, seed=seed,
                             predicate=qcfg.policy.param_predicate(),
                             onchip_prng=qcfg.onchip_prng,
                             backend=qcfg.backend, inplace=inplace)


def quantize_params(params, fmt: FixedPointFormat, qcfg: QuantConfig,
                    seed: int, inplace: bool = False, keep=None):
    """Snap the parameter tree to the weight grid. Returns (qparams, stats).
    ``keep`` (a bool device scalar, with ``inplace``): each leaf takes its
    snap only where ``keep`` holds — the guards' skip gate; the snap is made
    beside the leaf, one leaf at a time, and selected into it."""
    if not qcfg.enabled or not qcfg.policy.quantizes("weights"):
        return params, QuantStats.zero(device=fmt.il.device)
    if keep is None:
        return _quantize_tree(params, fmt, qcfg, seed, inplace)
    stats = []
    for i, (path, leaf) in enumerate(tree_lib.leaves_with_path(params)):
        q, st = fxp.quantize_tree_leaf(
            i, path, leaf, fmt, mode=qcfg.rounding, seed=seed,
            predicate=qcfg.policy.param_predicate(),
            onchip_prng=qcfg.onchip_prng, backend=qcfg.backend)
        if st is not None:
            torch.where(keep, q, leaf, out=leaf)
            stats.append(st)
        del q
    return params, fxp.merge_tree_stats(stats, fmt)


def quantize_grads(grads, fmt: FixedPointFormat, qcfg: QuantConfig,
                   seed: int, inplace: bool = False):
    """Quantize parameter gradients before the optimizer step."""
    if not qcfg.enabled or not qcfg.policy.quantizes("grads"):
        return grads, QuantStats.zero(device=fmt.il.device)
    return _quantize_tree(grads, fmt, qcfg, seed, inplace)


# ---------------------------------------------------------------------------
# Train state + generic quantized train step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    step: int                # host integer: seeds and schedules read it
    params: Any
    opt_state: Any
    dps: Any                 # DpsBundle of controller states (device tensors)
    seed: int                # run seed; every event's seed folds from it
    last_loss: Any = None
    # repro_torch.resilience.GuardState when qcfg.guards is armed; None
    # keeps a guard-free state's checkpoint keys as they were
    guard: Any = None

    @staticmethod
    def create(params, opt_state, qcfg: QuantConfig, seed: int,
               device=None) -> "TrainState":
        if device is None:
            device = tree_lib.leaves(params)[0].device
        guard = None
        if qcfg.guards is not None:
            from repro_torch.resilience import guards as guards_lib
            guard = guards_lib.init_guard_state(qcfg.plan(), device)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          dps=init_dps_bundle(qcfg, device), seed=seed,
                          last_loss=torch.zeros((), dtype=torch.float32,
                                                device=device),
                          guard=guard)


def _axis_size(transport) -> int:
    return transport.axis_size if transport is not None else 1


def zero_opt_engaged(qcfg: QuantConfig, transport) -> bool:
    """Does the ZeRO-1 sharded-optimizer path engage for (qcfg,
    transport)?  ``zero_opt_shards`` set and equal to the transport's axis
    size, larger than 1 — the checks :func:`make_train_step` makes (a
    mismatch warns there and runs the replicated optimizer state)."""
    n = _axis_size(transport)
    return (qcfg.zero_opt_shards is not None and n > 1
            and qcfg.zero_opt_shards == n)


def wire_sync_engaged(qcfg: QuantConfig, transport) -> bool:
    """Does the compressed gradient all-reduce engage for (qcfg,
    transport)?"""
    return qcfg.grad_allreduce_bits is not None and _axis_size(transport) > 1


def wire_params_engaged(qcfg: QuantConfig, params, transport) -> bool:
    """Does the ZeRO-1 parameter all-gather ride the int8 wire?  The flat
    legs cannot honor per-leaf carve-outs, so only when the quantization
    policy covers EVERY parameter leaf (``params``: a tree of tensors or of
    anything with the same paths) and no fp master copy is promised
    (``master_weights``); otherwise the updated parameters are gathered in
    fp32 and the flat optimizer-input snap is skipped."""
    if not (zero_opt_engaged(qcfg, transport)
            and wire_sync_engaged(qcfg, transport)):
        return False
    if qcfg.master_weights:
        return False
    pred = qcfg.policy.param_predicate()
    return all(pred(path, leaf)
               for path, leaf in tree_lib.leaves_with_path(params))


def zero_partitioner(qcfg: Optional[QuantConfig], params, n_shards: int):
    """The flat ZeRO-1 layout this config shards its optimizer state over:
    the plain :class:`~repro_torch.dist.sharding.ZeroPartitioner`, unless
    the compressed sync runs per-layer ``wire_grads`` formats or the
    overlapped wire — then the
    :class:`~repro_torch.dist.sharding.GroupAlignedPartitioner`, bucketed
    by :func:`~repro_torch.dist.overlap.plan_buckets` (the overlap's own
    plan) when ``wire_overlap``.  ``params``: a tree of tensors (or of
    anything with ``shape`` and ``dtype``)."""
    from repro_torch.dist import overlap as overlap_lib   # dist imports core
    from repro_torch.dist.sharding import (GroupAlignedPartitioner,
                                           ZeroPartitioner)
    if qcfg is None:
        return ZeroPartitioner.create(params, n_shards)
    plan = qcfg.plan()
    groups = plan.spec("wire_grads").groups if "wire_grads" in plan else 0
    if not (qcfg.grad_allreduce_bits is not None
            and (groups > 0 or qcfg.wire_overlap)):
        return ZeroPartitioner.create(params, n_shards)
    buckets = None
    if qcfg.wire_overlap:
        sizes = tuple(math.prod(l.shape) or 1
                      for l in tree_lib.leaves(params))
        bplan = overlap_lib.plan_buckets(
            sizes, qcfg.wire_bucket_elems or overlap_lib.DEFAULT_BUCKET_ELEMS)
        buckets = tuple(sorted(bplan.buckets))
    return GroupAlignedPartitioner.create(params, n_shards, buckets=buckets)


def zero_opt_state(optimizer, params, transport,
                   qcfg: Optional[QuantConfig] = None):
    """ZeRO-1 optimizer state: ``optimizer.init_shard`` over the flat
    layout of :func:`zero_partitioner`, one ``[shard_size]`` row per rank
    the transport holds — every rank's on a :class:`StackedTransport`, one
    on a process group (1/n of the replicated state's bytes).  Pass the
    run's ``qcfg``: per-layer and overlapped wires shard another layout."""
    part = zero_partitioner(qcfg, params, transport.axis_size)
    device = tree_lib.leaves(params)[0].device
    return optimizer.init_shard((len(transport.ranks), part.shard_size),
                                device)


def _optimizer_grad_domain(optimizer, plan: PrecisionPlan) -> str:
    """The precision domain whose format snaps ``optimizer``'s input
    gradients (Alg. 1 line 17): its ``grad_domain`` (``"grads"`` by
    default), which the plan must declare."""
    name = getattr(optimizer, "grad_domain", "grads")
    if name not in plan:
        raise ValueError(
            f"{type(optimizer).__name__}.grad_domain = {name!r} names "
            f"no precision domain in the plan ({plan.names}); the optimizer-"
            "input gradient quantization needs its format from the registry")
    return name


def _resnaps(qcfg: QuantConfig) -> bool:
    """Does the step re-snap the updated weights (Alg. 1 line 19)?"""
    return (qcfg.enabled and qcfg.policy.quantizes("weights")
            and not qcfg.master_weights)


def _domain_metrics(plan: PrecisionPlan, fmts, streams, loss, aux) -> dict:
    """The step's telemetry: the loss (and a MoE model's ``aux_loss``),
    ⟨IL, FL⟩ and E/R per domain (a per-group domain by its mean, and its
    formats' min and max)."""
    short = {"weights": "w", "acts": "a", "grads": "g"}
    metrics = {"loss": loss}
    if "aux_loss" in aux:          # MoE load-balance loss (in ``loss``)
        metrics["aux_loss"] = aux["aux_loss"]
    for name, spec in plan.domains:
        fmt, tag = fmts[name], short.get(name, name)
        if spec.groups:
            metrics[f"il_{tag}"] = fmt.il.to(torch.float32).mean()
            metrics[f"fl_{tag}"] = fmt.fl.to(torch.float32).mean()
            for f in ("il", "fl"):
                v = getattr(fmt, f)
                metrics[f"{f}_{tag}_min"] = v.min()
                metrics[f"{f}_{tag}_max"] = v.max()
        else:
            metrics[f"il_{tag}"] = fmt.il
            metrics[f"fl_{tag}"] = fmt.fl
        st = streams.get(spec.stream(name))
        if st is not None:
            scalar = (lambda v: v.mean()) if spec.groups else (lambda v: v)
            metrics[f"E_{tag}"] = scalar(st.quant_error())
            metrics[f"R_{tag}"] = scalar(st.overflow_rate())
    return metrics


def make_train_step(loss_fn, optimizer, qcfg: QuantConfig,
                    accum_steps: int = 1, transport=None, faults=None):
    """Build a quantized SGD/AdamW train step around ``loss_fn``.

    ``loss_fn(params, batch, qctx) -> (loss, aux)`` where ``aux`` is a dict
    that may hold ``"act_stats"`` (merged QuantStats of the taps),
    ``"last_act_stats"`` and ``"dlogits_stats"`` (last-layer statistics),
    and ``"aux_loss"`` (a MoE model's load-balance loss, already in
    ``loss``; reported as the metric ``aux_loss``).
    Returns ``step(state, batch) -> (state, metrics)``; the state is
    advanced in place and returned, the metrics are device tensors (reading
    them is the caller's host sync).

    ``accum_steps > 1`` splits the batch into microbatches run one after
    the other with fp32 gradient accumulation.

    ``qcfg.grad_allreduce_bits`` + a ``transport``
    (:mod:`repro_torch.dist.transport`) of more than one rank: data
    parallelism over the int8 wire.  The batch splits into one slice per
    rank (rank r takes rows ``r·B/n … (r+1)·B/n``, as the reference's
    ``P(data)`` splits it); each rank the transport holds runs its forward
    and backward, the dispatch leg of the tree all-reduce (K2b per leaf into
    its row of the int8 payload; K2 with a bits operand unless
    ``qcfg.onchip_prng``) and its raw-gradient statistics, after which its
    fp32 gradients are dropped; then the rest of the all-reduce gives every
    rank the decoded mean, which goes through the optimizer-input
    quantization and the optimizer as in the replicated step.  The wire
    ⟨IL, FL⟩ comes from the ``wire_grads`` domain, fed by the dispatch-leg
    stats; the grads domain is fed by the compute-grid stats of the RAW
    local gradients (the decoded mean already sits on the wire grid: its
    own stats would starve the controller).  With one rank (or no
    transport) the step is the replicated one, bit for bit.

    ``qcfg.wire_overlap``: the all-reduce runs per bucket
    (:class:`repro_torch.dist.overlap.BucketedWire`): each gradient leaf is
    encoded from a post-accumulate-grad hook the moment the backward has
    it, and a bucket's collective is issued once every rank held has
    encoded it.  With ``accum_steps > 1`` the leaves are encoded once the
    last microbatch has been accumulated: the buckets still run, but
    nothing overlaps the backward, and ``.wire_overlap_active`` is False.
    Bit-equal to the monolithic wire under both rounding modes.

    ``qcfg.zero_opt_shards``: ZeRO-1.  The parameters live in one flat
    fp32 buffer of :func:`zero_partitioner`'s layout (the step lays the
    state's tree out there, as views, on its first call), the optimizer
    state is :func:`zero_opt_state`'s, and each owner steps its slice.
    Without the wire the gradients are the replicated step's and the step
    is bit-equal to it (fp32 state, no clipping).  With it, the gradients
    reach each owner through the int8 reduce-scatter: on the group-aligned
    layout (per-layer formats, or the overlap) each owner's values are
    bit-equal to its chunk of the all-reduce's mean, so while the params
    leg stays fp32 the step equals the wire step bit for bit, except where
    the wire step's optimizer-input snap moves a value already on the grid
    (stochastic rounding of ``k + u`` in fp32 can round up when ``k`` is
    large), a snap the ZeRO step skips as the reference's does; on the plain
    layout (one format, no overlap) the owner means its chunk without the
    all-reduce's second snap, as the reference does.  When the policy
    quantizes every leaf, the optimizer input is snapped on the flat shard
    and the updated parameters come back through the int8 ``wire_params``
    all-gather.  Rank by rank as above, then owner by owner: K4 and the
    leg-2 snap (already run per bucket by the overlap), the local decode,
    the optimizer-input snap, ``update_shard`` on the owner's slice of the
    flat parameters; then the params leg (int8: each owner's new slice
    encoded right after its update).  One fp32 gradient shard exists at a
    time; with ``clip_norm`` or the guards the shards are decoded twice (the
    norm needs every owner's before the first updates).

    ``qcfg.guards`` (:class:`repro_torch.resilience.GuardConfig`) arms the
    health guards on every step above: whether the raw local gradients hold
    a NaN/Inf (summed over the ranks), the norm of the (decoded mean)
    gradients and the wire legs' overflow feed
    :func:`~repro_torch.resilience.update_guard`; the skip gate ``ok`` is
    computed on the device before the in-place update, and the optimizer,
    the weight re-snap and the DPS update select leaf by leaf against it
    (:mod:`repro_torch.resilience.guards`).  A tripped gradient wire runs
    the next step's all-reduce (or ZeRO's reduce-scatter) as the exact fp32
    mean (:class:`~repro_torch.dist.collectives.F32TreeMean`), a tripped
    ``wire_params`` leg the next step's all-gather in fp32: the step reads
    last step's ``degraded`` flags to the host, one sync a step.  Under
    ZeRO-1 the norm is that of the decoded, snapped owner shards, as the
    reference's: a first pass makes each owner's shard, sums its squares
    and drops it, and the update pass makes it again (its rounding bits are
    a function of the seed); the int8 params leg encodes the ungated new
    parameters (the reference encodes ``pshard + upd`` before its select)
    and its decode selects against the flat buffer, so a skipped step
    leaves it bit for bit.  ``faults``
    (:class:`repro_torch.resilience.FaultPlan`) injects the scheduled
    gradient faults after each rank's backward (leaf by leaf in the
    overlapped wire's hooks, before the leaf's encode) and the wire flip
    into the monolithic wire's payload.  Metrics add ``health``,
    ``skipped``, ``trips`` and ``degraded``.

    The plan is ``qcfg.plan()`` (``qcfg.precision_plan`` when set).
    ``optimizer.grad_domain`` names the plan's domain whose format snaps
    the optimizer's input gradients, on every body above (a domain the
    plan lacks raises ``ValueError``); ``qcfg.master_weights`` keeps the
    updated weights off the grid: no body re-snaps them, and ZeRO-1's
    params leg stays fp32.

    ``train_step.wire_sync_active``, ``.zero_opt_active``,
    ``.wire_overlap_active`` (the hooks ran),
    ``.zero_groupaligned_active`` and ``.guards_active`` say which ran;
    ``.qcfg`` and ``.transport`` are the ones it was built with.
    """
    plan = qcfg.plan()
    rounding = getattr(plan.controller("weights"), "rounding", qcfg.rounding)
    grad_domain = _optimizer_grad_domain(optimizer, plan)
    wire_bits = qcfg.grad_allreduce_bits
    if wire_bits is not None and not 2 <= wire_bits <= 8:
        raise ValueError(f"grad_allreduce_bits={wire_bits}: the wire payload "
                         "is int8, so only 2..8 grid bits are supported")
    n_data = _axis_size(transport)
    wire_sync = wire_sync_engaged(qcfg, transport)
    # engagement policy (the reference's): a config the transport cannot
    # honor warns and falls back; an impossible one raises
    zero_opt = qcfg.zero_opt_shards is not None and n_data > 1
    if zero_opt and qcfg.zero_opt_shards != n_data:
        warnings.warn(
            f"zero_opt_shards={qcfg.zero_opt_shards} does not match the "
            f"transport's data axis ({n_data} ranks); the optimizer state "
            "shards over that axis. Falling back to the replicated "
            "optimizer state.")
        zero_opt = False
    if zero_opt and not hasattr(optimizer, "update_shard"):
        raise TypeError(f"{type(optimizer).__name__} has no shard-local "
                        "update_shard/init_shard interface; ZeRO-1 needs it")
    wire_groups = plan.spec("wire_grads").groups if "wire_grads" in plan else 0
    wire_overlap = bool(qcfg.wire_overlap) and wire_sync
    zero_aligned = zero_opt and wire_sync and (wire_groups > 0 or wire_overlap)
    if wire_sync or zero_opt:
        from repro_torch.dist import collectives    # dist imports core
        from repro_torch.dist import overlap as overlap_lib
        from repro_torch.optim.optimizers import shard_sq_norm
        bucket_elems = (qcfg.wire_bucket_elems
                        or overlap_lib.DEFAULT_BUCKET_ELEMS)
    hooked = wire_overlap and accum_steps == 1
    measure_grads = qcfg.enabled and qcfg.policy.quantizes("grads")
    guards_on = qcfg.guards is not None
    if guards_on or faults is not None:
        from repro_torch import resilience as rsl
    if (faults is not None and faults.wire_flip_at >= 0
            and not (wire_sync and not wire_overlap and not zero_opt)):
        raise ValueError(
            "FaultPlan.wire_flip_at targets the monolithic tree all-reduce "
            "payload; it needs an engaged compressed sync without "
            "wire_overlap or zero_opt_shards")
    wire_names = rsl.wire_domains(plan) if guards_on else ()
    gidx = (wire_names.index("wire_grads") if "wire_grads" in wire_names
            else 0)
    pidx = (wire_names.index("wire_params") if "wire_params" in wire_names
            else None)
    layout = {}              # the step's partitioner and full_quant, once

    def _qctx(fmts, seed_a, microbatch_idx):
        if not (qcfg.enabled and qcfg.policy.quantizes("acts")):
            return None
        return QCtx(acts_fmt=fmts["acts"], grads_fmt=fmts["grads"],
                    seed=fold_seed(seed_a, microbatch_idx),
                    rounding=rounding, collect_stats=True,
                    onchip_prng=qcfg.onchip_prng, backend=qcfg.backend)

    def _grads(qparams, batch, fmts, seed_a, microbatch_idx):
        leaves = [leaf.detach().requires_grad_()
                  for leaf in tree_lib.leaves(qparams)]
        loss, aux = loss_fn(tree_lib.from_leaves(qparams, leaves), batch,
                            _qctx(fmts, seed_a, microbatch_idx))
        # a leaf the loss does not reach (the MoE experts behind an int8
        # all-to-all payload) gets a zero gradient, as in the reference
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), aux, tree_lib.from_leaves(qparams, list(grads))

    def _accum_grads(qparams, batch, fmts, seed_a):
        if accum_steps == 1:
            return _grads(qparams, batch, fmts, seed_a, 0)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             "microbatches")
        m = n // accum_steps
        loss_acc, g_acc, stats, moe_aux = None, None, None, None
        for i in range(accum_steps):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, aux, g = _grads(qparams, micro, fmts, seed_a, i)
            g = tree_lib.map_tree(lambda x: x.to(torch.float32), g)
            g_acc = g if g_acc is None else tree_lib.map_tree(
                torch.add, g_acc, g)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            s = aux.get("act_stats")
            if s is not None:
                stats = s if stats is None else stats.merge(s)
            a = aux.get("aux_loss")
            if a is not None:
                moe_aux = a if moe_aux is None else moe_aux + a
        grads = tree_lib.map_tree(lambda x, p: (x / accum_steps).to(p.dtype),
                                  g_acc, qparams)
        aux = {} if stats is None else {"act_stats": stats}
        if moe_aux is not None:
            aux["aux_loss"] = moe_aux / accum_steps
        return loss_acc / accum_steps, aux, grads

    def _raw_leaf_stats(g, path, grad, fmts, seed_g, rank):
        """Leaf ``g`` of :func:`_raw_grad_stats`, in place."""
        _, st = fxp.quantize_tree_leaf(
            g, path, grad, fmts[grad_domain], mode=qcfg.rounding,
            seed=fold_seed(seed_g, rank),
            predicate=qcfg.policy.param_predicate(),
            onchip_prng=qcfg.onchip_prng, backend=qcfg.backend, inplace=True)
        return st

    def _raw_grad_stats(grads, fmts, seed_g, rank):
        """Compute-grid gradient stats measured on the RAW local gradients
        (the reference's ``_raw_grad_stats``): the replicated step's
        gradient quantization event, for its statistics only.  It runs in
        place — the caller has encoded these gradients and drops them.
        Writing q costs the launch nothing: it is bound by the statistics'
        arithmetic, not by its bytes."""
        if not measure_grads:
            return QuantStats.zero(device=fmts["grads"].il.device)
        _, st = quantize_grads(grads, fmts[grad_domain], qcfg,
                               fold_seed(seed_g, rank), inplace=True)
        return st

    def _hooked_rank_pass(qparams, rows, fmts, seed_a, seed_g, rank, sink,
                          step=0, want_bad=False):
        """One rank's forward and backward with a post-accumulate-grad hook
        on every leaf: the moment the backward has a leaf's gradient, the
        hook applies the scheduled faults of ``step`` to it, takes its
        extrema (``want_bad``: the guards' nonfinite signal), encodes it
        into ``sink`` (the bucketed wire issues a bucket's collective once
        it is complete), measures its raw statistics and drops it.  Returns
        the loss, aux, raw stats and (``want_bad``) whether any leaf held a
        NaN/Inf."""
        paths = tree_lib.leaves_with_path(qparams)
        leaves = [leaf.detach().requires_grad_() for _, leaf in paths]
        raw = [None] * len(leaves)
        extrema = []

        bucket_of = (sink.bucket_of if getattr(sink, "landmarks", False)
                     else None)

        def hook_for(g):
            def hook(leaf):
                grad, leaf.grad = leaf.grad, None
                if bucket_of is not None:
                    tagging.tag(grad, "wire_bucket", stage="grad",
                                bucket=bucket_of[g], n=len(sink.runs),
                                leaf=g, rank=rank)
                if faults is not None:
                    rsl.apply_leaf_faults(faults, grad, step)
                if want_bad:
                    extrema.append(rsl.leaf_extrema(grad))
                sink.encode_leaf(rank, g, grad)
                if measure_grads:
                    raw[g] = _raw_leaf_stats(g, paths[g][0], grad, fmts,
                                             seed_g, rank)
            return hook

        handles = [leaf.register_post_accumulate_grad_hook(hook_for(g))
                   for g, leaf in enumerate(leaves)]
        try:
            loss, aux = loss_fn(tree_lib.from_leaves(qparams, leaves), rows,
                                _qctx(fmts, seed_a, 0))
            torch.autograd.backward(loss, inputs=leaves)
        finally:
            for h in handles:
                h.remove()
        if sink.missing(rank):
            raise RuntimeError(f"leaves {sink.missing(rank)} got no gradient "
                               "from the backward")
        bad = (rsl.nonfinite_of_extrema(extrema, fmts["grads"].il.device)
               if want_bad else None)
        if not measure_grads:
            return loss.detach(), aux, QuantStats.zero(
                device=fmts["grads"].il.device), bad
        return loss.detach(), aux, fxp.merge_tree_stats(
            [s for s in raw if s is not None], fmts[grad_domain]), bad

    def _rank_rows(qparams, batch) -> int:
        """Rows of the batch per rank, after checking that the batch splits
        into the ranks and that per-layer formats have a row per leaf."""
        n = next(iter(batch.values())).shape[0]
        if n % n_data:
            raise ValueError(f"batch {n} does not split into {n_data} "
                             "data-parallel ranks")
        n_leaves = len(tree_lib.leaves(qparams))
        if wire_groups and n_leaves != wire_groups:
            raise ValueError(
                f"wire_grads_groups={wire_groups} but the gradient tree has "
                f"{n_leaves} leaves; per-layer wire formats need one group "
                "per leaf (derive the config with "
                "QuantConfig.with_per_layer_wire(params))")
        return n // n_data

    def _rank_passes(qparams, batch, fmts, seed_a, seed_g, sink, step=0,
                     bads=None):
        """Every rank the transport holds in turn: its slice of the batch
        forward and backward (then the scheduled gradient faults of
        ``step``, and with ``bads`` whether its gradients hold a NaN/Inf
        appended there), its leg-1 encode into ``sink`` and its raw-gradient stats;
        its fp32 gradients are dropped before the next rank's backward.
        Returns the per-rank losses, aux dicts and raw stats."""
        m = _rank_rows(qparams, batch)
        losses, auxes, raws = [], [], []
        for r in transport.ranks:
            rows = {k: v[r * m:(r + 1) * m] for k, v in batch.items()}
            sa = fold_seed(seed_a, r)
            if hooked:
                loss, aux, raw, bad = _hooked_rank_pass(
                    qparams, rows, fmts, sa, seed_g, r, sink, step,
                    bads is not None)
                if bads is not None:
                    bads.append(bad)
            else:
                loss, aux, grads = _accum_grads(qparams, rows, fmts, sa)
                if faults is not None:
                    rsl.apply_grad_faults(faults, grads, step)
                if bads is not None:
                    bads.append(rsl.nonfinite_any(grads))
                sink.encode(r, grads)
                raw = _raw_grad_stats(grads, fmts, seed_g, r)
                del grads
            losses.append(loss)
            auxes.append(aux)
            raws.append(raw)
        return losses, auxes, raws

    def _pmean(values):
        return transport.psum(torch.stack(values)) / n_data

    def _reduce_ranks(losses, auxes, raws):
        """The per-rank losses, aux dicts and raw stats over the axis."""
        aux = {k: (collectives.psum_stats([a[k] for a in auxes], transport)
                   if isinstance(v, QuantStats)
                   else _pmean([a[k] for a in auxes]))
               for k, v in auxes[0].items()}
        return (_pmean(losses), aux,
                collectives.psum_stats(raws, transport))

    def _wire_synced_grads(qparams, batch, fmts, seed_a, seed_g, seed_r,
                           step=0, degraded=False):
        """The int8 all-reduce of every rank's gradients (bucketed with
        ``wire_overlap``; the exact fp32 mean when ``degraded``).  Returns
        the loss, aux, raw stats, the mean gradient tree, the dispatch
        leg's stats and (guards armed, else None) the number of ranks whose
        raw gradients hold a NaN/Inf.  On a degraded step the overlap's
        hooks add each leaf to the fp32 sum: no bucket collective runs."""
        _rank_rows(qparams, batch)
        if degraded:
            sink = collectives.F32TreeMean(qparams, fmts, transport,
                                           domain="wire_grads")
        elif wire_overlap:
            sizes = tuple(l.numel() for l in tree_lib.leaves(qparams))
            sink = overlap_lib.BucketedWire(
                qparams, fmts, transport, seed_r,
                runs=sorted(overlap_lib.plan_buckets(sizes,
                                                     bucket_elems).buckets),
                mode=rounding, backend=qcfg.backend, domain="wire_grads",
                onchip_prng=qcfg.onchip_prng)
        else:
            sink = collectives.TreeAllReduce(
                qparams, fmts, transport, seed_r, mode=rounding,
                domain="wire_grads", backend=qcfg.backend,
                onchip_prng=qcfg.onchip_prng,
                payload_fault=(rsl.payload_fault_fn(faults, step)
                               if faults is not None else None))
        if not degraded:
            train_step.wire_buckets = len(getattr(sink, "buckets", (sink,)))
        bads = [] if guards_on else None
        passes = _rank_passes(qparams, batch, fmts, seed_a, seed_g, sink,
                              step, bads)
        grads, wstats = sink.finish()
        bad = transport.psum(torch.stack(bads)) if guards_on else None
        return (*_reduce_ranks(*passes), grads,
                collectives.psum_stats(wstats, transport), bad)

    def _owner_grads(sink, i, j, fmts, seed_g, full_quant):
        """Owner row ``i`` (rank ``j``)'s fp32 gradient shard, one segment
        per bucket: decoded from its snap (aligned) or meaned by K4
        (plain), then snapped onto the gradient grid when ``full_quant``
        (the reference's optimizer-input quantization of the flat shard)."""
        segs = (sink.owner_segments(i) if zero_aligned
                else [sink.owner_mean(i)])
        if full_quant and measure_grads:
            for b, g in enumerate(segs):
                ops.dps_quantize(g, fmts[grad_domain], ops.event_bits(
                    g, qcfg.rounding, fold_seed(seed_g, 0x524157 + j, b),
                    qcfg.onchip_prng), compute_stats=False, out=g,
                    backend=qcfg.backend)
        return segs

    def _owner_sq_norm(owner_grads):
        """Σ g² over every owner's gradient shard, summed over the axis:
        the clip's and the guards' norm, one owner's shard at a time."""
        return transport.psum(torch.stack([
            shard_sq_norm(owner_grads(i, j))
            for i, j in enumerate(transport.ranks)]))

    def _update_owner(part, flat, opt_state, count, i, j, segs, sq=None,
                      keep=None, want_new=False):
        """``update_shard`` on owner row ``i`` (rank ``j``)'s slice of the
        flat parameters, segment by segment.  Returns its new parameter
        segments: views of ``flat``, or with ``keep`` and ``want_new`` the
        ungated new values (the int8 params leg encodes them)."""
        new = []
        for b, (g, p, (_, so, cnt)) in enumerate(zip(
                segs, part.shard_segments(flat, j), part.segments(j))):
            st = {k: v[i, so:so + cnt] for k, v in opt_state.items()}
            buf = (torch.empty_like(p) if keep is not None and want_new
                   else None)
            optimizer.update_shard(g, st, p, count, rank=j, segment=b,
                                   sq_norm=sq, keep=keep, new_out=buf)
            new.append(p if buf is None else buf)
        return new

    def _update_owners(part, flat, opt_state, count, owner_grads, sq=None,
                       keep=None):
        """:func:`_update_owner` on each held owner; ``owner_grads(i, j)``
        gives owner row ``i``'s gradient segments (called twice under
        clipping, unless ``sq`` is given)."""
        if sq is None and getattr(optimizer.cfg, "clip_norm", 0):
            sq = _owner_sq_norm(owner_grads)
        for i, j in enumerate(transport.ranks):
            _update_owner(part, flat, opt_state, count, i, j,
                          owner_grads(i, j), sq, keep)

    def _gather_f32(part, flat):
        """The fp32 params leg: every shard held was updated in place in
        ``flat``; the others come from the all-gather (nothing to move when
        this process holds every rank)."""
        if len(transport.ranks) == n_data:
            return
        own = torch.stack([part.shard(flat, j) for j in transport.ranks])
        part.assemble(transport.all_gather(own).view(n_data, -1), out=flat)

    def _zero_wire_step(part, flat, full_quant, qparams, state, fmts,
                        batch, seed_a, seed_g, seed_r, deg_g=False,
                        deg_p=False):
        """ZeRO-1 over the wire: the rank passes into the sharded
        reduce-scatter (group-aligned buckets, or the plain packed layout;
        ``deg_g``: the exact fp32 one), then owner by owner the gradient
        shard and ``update_shard``, then the params leg (int8 when
        ``full_quant`` and not ``deg_p``, else fp32).  Guards armed: the
        ranks' nonfinite signal and the norm of the owner shards (a first
        pass over them) give the skip gate before any update, and every
        write selects against it.  Returns the loss, aux, raw stats, both
        legs' stats, and (guards armed) the nonfinite count, the norm and
        the gate."""
        _rank_rows(qparams, batch)
        if deg_g:
            sink = collectives.F32TreeMean(qparams, fmts, transport,
                                           domain="wire_grads", part=part)
        elif zero_aligned:
            # seed_r goes to both legs verbatim: the draws of the
            # replicated tree all-reduce, bit for bit
            sink = overlap_lib.zero_wire(
                qparams, fmts, transport, seed_r, part=part, mode=rounding,
                backend=qcfg.backend, domain="wire_grads",
                onchip_prng=qcfg.onchip_prng, eager=wire_overlap)
        else:
            sink = collectives.TreeAllReduce(
                qparams, fmts, transport, fold_seed(seed_r, 1),
                mode=rounding, domain="wire_grads", backend=qcfg.backend,
                onchip_prng=qcfg.onchip_prng, chunk=part.shard_size)
        if not deg_g:
            train_step.wire_buckets = len(getattr(sink, "buckets", (sink,)))
        bads = [] if guards_on else None
        passes = _rank_passes(qparams, batch, fmts, seed_a, seed_g, sink,
                              state.step, bads)
        loss, aux, g_stats = _reduce_ranks(*passes)
        g_wire = collectives.psum_stats(sink.stats, transport)
        owner_grads = lambda i, j: _owner_grads(sink, i, j, fmts, seed_g,
                                                full_quant)
        sq = bad = gnorm = ok = None
        if guards_on or getattr(optimizer.cfg, "clip_norm", 0):
            # a first pass over the owner shards: the clip's norm, and the
            # guards' (the reference's g2, decoded and snapped)
            sq = _owner_sq_norm(owner_grads)
        if guards_on:
            # the skip gate before any in-place write
            bad = transport.psum(torch.stack(bads))
            gnorm = torch.sqrt(sq)
            ok = rsl.step_ok(qcfg.guards, state.guard, loss=loss,
                             grads_bad=bad, gnorm=gnorm)
        if full_quant and not deg_p:
            kw = dict(mode=rounding, backend=qcfg.backend,
                      domain="wire_params", onchip_prng=qcfg.onchip_prng,
                      out=flat, keep=ok)

            def updated(i, j):
                # owner i steps its slice, then its new parameters go on
                # the wire: one owner's gradient shard at a time
                return _update_owner(part, flat, state.opt_state, state.step,
                                     i, j, owner_grads(i, j), sq, ok, True)
            if zero_aligned:
                _, pst = overlap_lib.zero_allgather_params(
                    updated, fmts, transport, seed_r, part=part, **kw)
            else:
                _, pst = collectives.dps_allgather_params(
                    lambda i, j: updated(i, j)[0], fmts, transport,
                    fold_seed(seed_r, 2), **kw)
            p_wire = collectives.psum_stats(pst, transport)
        else:
            _update_owners(part, flat, state.opt_state, state.step,
                           owner_grads, sq, ok)
            _gather_f32(part, flat)
            p_wire = QuantStats.zero(fmts["wire_params"].il.shape,
                                     device=flat.device)
        del sink
        return loss, aux, g_stats, g_wire, p_wire, bad, gnorm, ok

    def _zero_plain_opt(part, flat, grads, state, keep=None):
        """ZeRO-1 without the wire: each held owner steps its slice of the
        (replicated) gradients, and the fp32 params leg follows — every
        leg exact, so the step is the replicated one bit for bit."""
        def owner_grads(i, j):
            shard = part.shard_from_tree(grads, j)
            return [shard[so:so + cnt] for _, so, cnt in part.segments(j)]

        _update_owners(part, flat, state.opt_state, state.step, owner_grads,
                       keep=keep)
        _gather_f32(part, flat)

    def _zero_layout(state):
        """The step's partitioner and full_quant, fixed on the first call;
        the state's parameters laid out in the flat buffer (as views)."""
        if not layout:
            layout["part"] = zero_partitioner(qcfg, state.params, n_data)
            fq = wire_sync and wire_params_engaged(qcfg, state.params,
                                                   transport)
            if wire_sync and not fq:
                warnings.warn(
                    "zero_opt_shards + grad_allreduce_bits: the policy "
                    "excludes some param leaves (or master_weights is "
                    "set), and the flat ZeRO layout cannot skip them "
                    "per-leaf — gathering updated params in fp32 and "
                    "skipping the flat optimizer-input gradient "
                    "quantization (the gradient wire stays int8).")
            layout["full_quant"] = fq
        part = layout["part"]
        flat = part.flat_of(state.params)
        if flat is None:
            flat, state.params = part.flat_view(state.params)
        return part, flat, layout["full_quant"]

    def train_step(state: TrainState, batch):
        dev = state.last_loss.device
        # counterpart of split(fold_in(rng, step), 3)
        seed_w, seed_g, seed_a = (fold_seed(state.seed, state.step, k)
                                  for k in range(3))
        # the wire path derives its own stream instead of widening the
        # step's split, so the replicated path keeps its seeds
        seed_r = fold_seed(state.seed, state.step, _WIRE_SALT)
        fmts = bundle_formats(qcfg, state.dps)
        if zero_opt:
            part, flat, full_quant = _zero_layout(state)

        # -- forward/backward in the quantized regime (Alg. 1 lines 9-20) --
        qparams, w_stats = quantize_params(state.params, fmts["weights"],
                                           qcfg, seed_w)
        wire_stats = bad = gnorm = ok = None
        degraded = deg_p = False
        if guards_on:
            if state.guard is None:
                raise ValueError(
                    "qcfg.guards is armed but TrainState.guard is None; build "
                    "the state with TrainState.create(..., qcfg, ...) or "
                    "restore with qtrain.guard_restore_defaults")
            if wire_sync and wire_names:
                # LAST step's flags pick THIS step's branches: one host sync
                flags = state.guard.degraded.tolist()
                degraded = bool(flags[gidx])
                deg_p = pidx is not None and bool(flags[pidx])
        if zero_opt and wire_sync:
            (loss, aux, g_stats, g_wire, p_wire, bad, gnorm,
             ok) = _zero_wire_step(part, flat, full_quant, qparams, state,
                                   fmts, batch, seed_a, seed_g, seed_r,
                                   degraded, deg_p)
            del qparams
            wire_stats = g_wire.merge(p_wire)
        elif wire_sync:
            loss, aux, g_stats, grads, wire_stats, bad = _wire_synced_grads(
                qparams, batch, fmts, seed_a, seed_g, seed_r, state.step,
                degraded)
            del qparams
            if guards_on:
                # the spike guard reads the DECODED mean: transport
                # corruption exists only there
                gnorm = rsl.global_norm(grads)
            # the optimizer-input snap still applies (Alg. 1); the grads
            # controller reads the raw-gradient measurement instead
            grads, _ = quantize_grads(grads, fmts[grad_domain], qcfg,
                                      seed_g, inplace=True)
        else:
            loss, aux, grads = _accum_grads(qparams, batch, fmts, seed_a)
            del qparams
            if faults is not None:
                rsl.apply_grad_faults(faults, grads, state.step)
            if guards_on:
                bad = rsl.nonfinite_any(grads)
                gnorm = rsl.global_norm(grads)
            grads, g_stats = quantize_grads(grads, fmts[grad_domain], qcfg,
                                            seed_g, inplace=True)
        if guards_on and ok is None:
            # the skip gate, on the device, before any in-place write
            ok = rsl.step_ok(qcfg.guards, state.guard, loss=loss,
                             grads_bad=bad, gnorm=gnorm)
        # -- update (Alg. 1 line 18), in place --
        if zero_opt and not wire_sync:
            _zero_plain_opt(part, flat, grads, state, keep=ok)
            del grads
        elif not zero_opt:
            optimizer.update(grads, state.opt_state, state.params,
                             count=state.step, keep=ok)
            del grads

        if "dlogits_stats" in aux and qcfg.stat_scope == "last_layer":
            g_stats = aux["dlogits_stats"]
        elif "dlogits_stats" in aux:
            g_stats = g_stats.merge(aux["dlogits_stats"])
        if qcfg.stat_scope == "last_layer" and "last_act_stats" in aux:
            a_stats = aux["last_act_stats"]
        else:
            a_stats = aux.get("act_stats", QuantStats.zero(device=dev))

        # -- re-snap weights to the grid (Alg. 1 line 19), in place --
        if _resnaps(qcfg):
            _, w_stats2 = quantize_params(state.params, fmts["weights"], qcfg,
                                          fold_seed(seed_w, 1), inplace=True,
                                          keep=ok)
            w_stats = w_stats.merge(w_stats2)

        # -- scale_precision (Alg. 2, one controller per domain); each wire
        # leg feeds its own domain, never a compute controller --
        streams = {"weights": w_stats, "acts": a_stats, "grads": g_stats}
        if zero_opt and wire_sync:
            streams["wire_grads"], streams["wire_params"] = g_wire, p_wire
        elif wire_stats is not None:
            streams["wire_grads"] = wire_stats
        new_dps = update_dps_bundle(qcfg, state.dps, streams, {"loss": loss})

        # -- health guards: fold this step's signals, gate the DPS update --
        if guards_on:
            # each wire leg feeds its own domain's overflow; a leg that did
            # not run on the int8 wire this step (a degraded leg, ZeRO's
            # fp32 params leg) is left out and reads 0, as its zero stats
            # would (the verifier's guard landmarks mark int8 legs only)
            if zero_opt and wire_sync:
                legs = {"wire_grads": g_wire, "wire_params": p_wire}
                if deg_p or not full_quant:
                    del legs["wire_params"]
            else:
                legs = ({"wire_grads": wire_stats} if wire_stats is not None
                        else {})
            if degraded:
                legs.pop("wire_grads", None)
            new_guard, _, trip_any = rsl.update_guard(
                qcfg.guards, plan, state.guard, loss=loss, grads_bad=bad,
                gnorm=gnorm, wire_ov=rsl.domain_overflow(plan, legs, dev),
                new_dps=new_dps, grads_domain_idx=gidx)
            new_dps = rsl.guards.select_bundle(ok, new_dps, state.dps)
            if qcfg.guards.widen_on_trip:
                new_dps = rsl.widen_on_trip(plan, new_dps, trip_any)
            state.guard = new_guard
        state.dps = new_dps

        # -- telemetry: ⟨IL, FL⟩ + E/R per domain (a per-group domain is
        # reported by its mean, and its formats' min and max) --
        metrics = _domain_metrics(plan, fmts, streams, loss, aux)
        if wire_stats is not None:
            ws = wire_stats
            if ws.count.ndim:          # [G] per-layer stats -> global view
                ws = QuantStats(*(f.sum() for f in (
                    ws.count, ws.nonzero, ws.overflow, ws.abs_err_sum,
                    ws.rel_err_sum, ws.abs_sum)), max_abs=ws.max_abs.max())
            metrics["E_wire"] = ws.quant_error()
            metrics["R_wire"] = ws.overflow_rate()
        if guards_on:
            g = state.guard
            metrics.update(health=g.health, skipped=g.skipped, trips=g.trips,
                           degraded=(g.degraded.max() if wire_names else
                                     torch.zeros((), dtype=torch.int32,
                                                 device=dev)))
        state.step += 1
        state.last_loss = loss.to(torch.float32)
        return state, metrics

    train_step.wire_sync_active = wire_sync
    train_step.zero_opt_active = zero_opt
    train_step.wire_overlap_active = hooked
    train_step.zero_groupaligned_active = zero_aligned
    train_step.guards_active = guards_on
    train_step.qcfg, train_step.transport = qcfg, transport
    train_step.wire_buckets = 0          # set by the first wire step
    train_step.n_data = n_data
    return train_step


# ---------------------------------------------------------------------------
# The placed step: the replicated step's body on each rank's blocks.
# ---------------------------------------------------------------------------

def _quantize_placed_tree(tree, fmt, qcfg: QuantConfig, seed: int,
                          inplace: bool = False, keep=None):
    """:func:`quantize_params`/:func:`quantize_grads` on a tree of placed
    leaves: each leaf's blocks with the whole leaf's bits, its statistics
    merged over its split axes, the leaves' merged in leaf order.  ``keep``
    (a bool device scalar, with ``inplace``): the guards' skip gate, as
    :func:`quantize_params` takes it — each distinct block is snapped
    beside itself and selected into it."""
    out, stats = [], []
    for i, (path, leaf) in enumerate(tree_lib.leaves_with_path(tree)):
        q, st = fxp.quantize_placed(
            i, path, leaf, fmt, mode=qcfg.rounding, seed=seed,
            predicate=qcfg.policy.param_predicate(),
            onchip_prng=qcfg.onchip_prng, backend=qcfg.backend,
            inplace=inplace, keep=keep)
        out.append(q)
        if st is not None:
            stats.append(st)
    return tree_lib.from_leaves(tree, out), fxp.merge_tree_stats(stats, fmt)


def _placed_grad_faults(faults, grads, step: int) -> None:
    """The scheduled gradient faults of ``step`` on a tree of placed
    gradients, in place, once on each distinct block: the holders of one
    shared block (:func:`_reduce_replicated`) hold one tensor, and the
    storm's product applied once a holder would compound."""
    from repro_torch import resilience as rsl     # resilience imports core
    for leaf in tree_lib.leaves(grads):
        for _, b in leaf.distinct():
            rsl.apply_leaf_faults(faults, b, step)


def _placed_nonfinite(grads, mesh):
    """The guards' nonfinite signal of a tree of placed gradients, one
    ``[1]`` tensor a held rank: 1.0 on every rank when any rank's block
    holds a NaN or an Inf, else 0.0.
    Each distinct block's extrema (one min/max reduction, as
    :func:`~repro_torch.resilience.guards.nonfinite_any` takes a leaf's)
    give each held rank its flag, and the flags are maxed over every mesh
    axis: one scalar collective an axis, and a block that only one process
    of a process mesh holds reaches every process."""
    from repro_torch import resilience as rsl
    flags, memo = None, {}
    for leaf in tree_lib.leaves(grads):
        ext = []
        for b in leaf.blocks:
            if id(b) not in memo:
                memo[id(b)] = rsl.nonfinite_of_extrema(
                    [rsl.leaf_extrema(b)], b.device).reshape(1)
            ext.append(memo[id(b)])
        flags = ext if flags is None else [torch.maximum(a, e)
                                           for a, e in zip(flags, ext)]
    axes = [a for a, n in sharding._axis_sizes(mesh).items() if n > 1]
    return sharding.pmax(mesh, axes, flags)


def _rank_leaves(leaf):
    """A placed leaf with one fresh autograd leaf a held rank (replicated
    ranks of a stacked mesh too: each rank's gradient is its own share,
    summed over the axes by :func:`_reduce_replicated`)."""
    return sharding.Placed([b.detach().requires_grad_() for b in leaf.blocks],
                           leaf.spec, leaf.mesh, leaf.shape)


def _reduce_replicated(leaf, grads):
    """Each rank's gradient of ``leaf`` summed over the axes the leaf is
    replicated on (an FSDP leaf's data-axis sum came with its all-gather's
    transpose): every holder of a block gets the block's whole gradient,
    the holders of one shared block (a stacked mesh's) one shared
    tensor."""
    with torch.no_grad():
        grads = sharding.psum(leaf.mesh, leaf.replicated_axes(), grads)
    first = {}
    for i, b in enumerate(leaf.blocks):
        first.setdefault(id(b), i)
    return sharding.Placed([grads[first[id(b)]] for b in leaf.blocks],
                           leaf.spec, leaf.mesh, leaf.shape)


def place_batch(batch, mesh, rules):
    """A global batch (whole tensors on every process) placed by the
    rules' ``batch`` axis on its leading dim."""
    return {k: sharding.place_tensor(
        v, rules.spec(("batch",) + (None,) * (v.ndim - 1), v.shape, mesh),
        mesh) for k, v in batch.items()}


def make_placed_train_step(loss_fn, optimizer, qcfg: QuantConfig, mesh,
                           rules, accum_steps: int = 1, faults=None):
    """The sharded train step: the replicated step's body (Alg. 1 and 2 as
    :func:`make_train_step` runs them) on a state placed over ``mesh``
    (:func:`repro_torch.launch.specs.place_train_state`), each rank on its
    blocks, under ``axis_rules(mesh, rules)``.

    ``loss_fn(params, batch, qctx) -> (loss, aux)`` is a family's placed
    loss (``models.transformer.placed_loss_fn``): params and batch are
    trees of :class:`~repro_torch.dist.sharding.Placed`, ``loss`` a placed
    scalar (every rank the global mean), ``aux`` as the replicated step's.
    The step:

    * snaps each held block of every leaf onto the weight grid with the
      bits the whole leaf's event gives it (K1b in block mode), the
      statistics merged over the leaf's split axes;
    * runs every held rank's forward and backward — the collectives the
      placement implies inside — as one program whose objective is the
      mean of the ranks' losses (each rank's gradient is its share);
    * sums each leaf's gradient over the axes it is replicated on (an FSDP
      leaf's sum over data is its all-gather's reduce-scatter);
    * snaps the gradient blocks, steps the optimizer on each distinct block
      (its state placed like the parameter), re-snaps, and feeds the
      merged statistics to the controllers, which every rank runs alike.

    ``accum_steps``: the global batch splits into microbatches of global
    rows, each placed over the data axis, as the reference slices it.

    The engagement policy is the reference's: the int8 wire and ZeRO-1 run
    on a pure data-parallel mesh only, so with a data axis above 1 and
    another axis above 1 either warns and falls back (the exact gradient
    sums of the placed backward; the optimizer state placed like the
    parameters), ``wire_sync_active`` and ``zero_opt_active`` False, the
    plan's ``wire_grads`` / ``wire_params`` domains kept as the reference
    keeps them.  On a pure data mesh either raises: the data-parallel
    step (:func:`make_train_step` with the axis's transport) runs them.

    ``qcfg.guards`` arms the health guards as on the replicated step, on
    the placed trees: after the backward the scheduled ``faults`` of the
    step hit each distinct gradient block once
    (:func:`_placed_grad_faults`); the nonfinite signal
    (:func:`_placed_nonfinite`) and the norm
    (:func:`~repro_torch.optim.optimizers.placed_sq_norm`, each leaf's
    blocks summed over its split axes) are taken from the raw gradients
    before their snap; the skip gate ``ok`` is computed on the device
    before any in-place write, and the optimizer and the weight re-snap
    select block by block against it.  The guard state is replicated
    scalars and ``[D]`` vectors, the same on every rank and process.
    ``FaultPlan.wire_flip_at`` raises: no wire payload runs here.
    ``optimizer.grad_domain`` and ``qcfg.master_weights`` as in
    :func:`make_train_step`."""
    sizes = sharding._axis_sizes(mesh)
    n_data = sizes.get("data", 1)
    others = any(n > 1 for a, n in sizes.items() if a != "data")
    wire_bits = qcfg.grad_allreduce_bits
    if wire_bits is not None and not 2 <= wire_bits <= 8:
        raise ValueError(f"grad_allreduce_bits={wire_bits}: the wire payload "
                         "is int8, so only 2..8 grid bits are supported")
    if ((wire_bits is not None or qcfg.zero_opt_shards is not None)
            and n_data > 1 and not others):
        raise ValueError(
            "the int8 gradient wire (grad_allreduce_bits) and ZeRO-1 "
            "(zero_opt_shards) on a pure data-parallel mesh run the "
            "data-parallel step (make_train_step with the data axis's "
            "transport), the parameters replicated")
    # engagement policy (the reference's): a config the mesh cannot honor
    # warns and falls back
    if wire_bits is not None and n_data > 1:
        warnings.warn(
            "grad_allreduce_bits needs a pure data-parallel mesh (all "
            f"non-'data' axes of size 1); got {sizes}. Falling back to the "
            "implicit fp32 gradient all-reduce.")
    if qcfg.zero_opt_shards is not None and n_data > 1:
        warnings.warn(
            "zero_opt_shards needs a pure data-parallel mesh (all "
            f"non-'data' axes of size 1); got {sizes}. Falling back to the "
            "replicated optimizer state.")
    guards_on = qcfg.guards is not None
    if guards_on or faults is not None:
        from repro_torch import resilience as rsl
        from repro_torch.optim.optimizers import placed_sq_norm
    if faults is not None and faults.wire_flip_at >= 0:
        raise ValueError(
            "FaultPlan.wire_flip_at targets the monolithic tree all-reduce "
            "payload; it needs an engaged compressed sync without "
            "wire_overlap or zero_opt_shards")
    plan = qcfg.plan()
    rounding = getattr(plan.controller("weights"), "rounding", qcfg.rounding)
    grad_domain = _optimizer_grad_domain(optimizer, plan)
    n_ranks = math.prod(sizes.values())
    wire_names = rsl.wire_domains(plan) if guards_on else ()
    gidx = (wire_names.index("wire_grads") if "wire_grads" in wire_names
            else 0)

    def _qctx(fmts, seed_a, mb):
        if not (qcfg.enabled and qcfg.policy.quantizes("acts")):
            return None
        return QCtx(acts_fmt=fmts["acts"], grads_fmt=fmts["grads"],
                    seed=fold_seed(seed_a, mb), rounding=rounding,
                    collect_stats=True, onchip_prng=qcfg.onchip_prng,
                    backend=qcfg.backend)

    def _grads(qparams, batch, fmts, seed_a, mb):
        leaves = [_rank_leaves(l) for l in tree_lib.leaves(qparams)]
        loss, aux = loss_fn(tree_lib.from_leaves(qparams, leaves),
                            place_batch(batch, mesh, rules),
                            _qctx(fmts, seed_a, mb))
        inputs = [b for l in leaves for b in l.blocks]
        w = torch.full((), 1.0 / n_ranks, dtype=loss.dtype,
                       device=loss.device)
        flat = torch.autograd.grad(loss.blocks, inputs,
                                   grad_outputs=[w] * len(loss.blocks),
                                   materialize_grads=True)
        grads, at = [], 0
        for l in tree_lib.leaves(qparams):
            n = len(l.blocks)
            grads.append(_reduce_replicated(l, list(flat[at:at + n])))
            at += n
        return (loss.blocks[0].detach(), aux,
                tree_lib.from_leaves(qparams, grads))

    def _accum_grads(qparams, batch, fmts, seed_a):
        if accum_steps == 1:
            return _grads(qparams, batch, fmts, seed_a, 0)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             "microbatches")
        m = n // accum_steps
        loss_acc, g_acc, stats, moe_aux = None, None, None, None
        for i in range(accum_steps):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, aux, g = _grads(qparams, micro, fmts, seed_a, i)
            g = tree_lib.map_tree(lambda x: x.map(
                lambda b: b.to(torch.float32)), g)
            g_acc = g if g_acc is None else tree_lib.map_tree(
                lambda a, b: a.map(torch.add, b), g_acc, g)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            s = aux.get("act_stats")
            if s is not None:
                stats = s if stats is None else stats.merge(s)
            a = aux.get("aux_loss")
            if a is not None:
                moe_aux = a if moe_aux is None else moe_aux + a
        grads = tree_lib.map_tree(
            lambda x, p: x.map(lambda b: (b / accum_steps).to(p.dtype)),
            g_acc, qparams)
        aux = {} if stats is None else {"act_stats": stats}
        if moe_aux is not None:
            aux["aux_loss"] = moe_aux / accum_steps
        return loss_acc / accum_steps, aux, grads

    def train_step(state: TrainState, batch):
        dev = state.last_loss.device
        seed_w, seed_g, seed_a = (fold_seed(state.seed, state.step, k)
                                  for k in range(3))
        fmts = bundle_formats(qcfg, state.dps)
        if guards_on and state.guard is None:
            raise ValueError(
                "qcfg.guards is armed but TrainState.guard is None; build "
                "the state with TrainState.create(..., qcfg, ...) or "
                "restore with qtrain.guard_restore_defaults")
        bad = gnorm = ok = None
        with sharding.axis_rules(mesh, rules):
            if qcfg.enabled and qcfg.policy.quantizes("weights"):
                qparams, w_stats = _quantize_placed_tree(
                    state.params, fmts["weights"], qcfg, seed_w)
            else:
                qparams, w_stats = state.params, QuantStats.zero(device=dev)
            loss, aux, grads = _accum_grads(qparams, batch, fmts, seed_a)
            del qparams
            if faults is not None:
                _placed_grad_faults(faults, grads, state.step)
            if guards_on:
                bad = _placed_nonfinite(grads, mesh)[0][0]
                gnorm = torch.sqrt(placed_sq_norm(grads))
                # the skip gate, on the device, before any in-place write
                ok = rsl.step_ok(qcfg.guards, state.guard, loss=loss,
                                 grads_bad=bad, gnorm=gnorm)
            if measure_grads:
                grads, g_stats = _quantize_placed_tree(
                    grads, fmts[grad_domain], qcfg, seed_g, inplace=True)
            else:
                g_stats = QuantStats.zero(device=dev)
            optimizer.update_placed(grads, state.opt_state, state.params,
                                    count=state.step, keep=ok)
            del grads
            a_stats = aux.get("act_stats", QuantStats.zero(device=dev))
            if _resnaps(qcfg):
                _, w_stats2 = _quantize_placed_tree(
                    state.params, fmts["weights"], qcfg,
                    fold_seed(seed_w, 1), inplace=True, keep=ok)
                w_stats = w_stats.merge(w_stats2)
        streams = {"weights": w_stats, "acts": a_stats, "grads": g_stats}
        new_dps = update_dps_bundle(qcfg, state.dps, streams, {"loss": loss})
        if guards_on:
            # no wire leg runs: every wire domain's overflow reads 0
            new_guard, _, trip_any = rsl.update_guard(
                qcfg.guards, plan, state.guard, loss=loss, grads_bad=bad,
                gnorm=gnorm, wire_ov=rsl.domain_overflow(plan, {}, dev),
                new_dps=new_dps, grads_domain_idx=gidx)
            new_dps = rsl.guards.select_bundle(ok, new_dps, state.dps)
            if qcfg.guards.widen_on_trip:
                new_dps = rsl.widen_on_trip(plan, new_dps, trip_any)
            state.guard = new_guard
        state.dps = new_dps
        metrics = _domain_metrics(plan, fmts, streams, loss, aux)
        if guards_on:
            g = state.guard
            metrics.update(health=g.health, skipped=g.skipped, trips=g.trips,
                           degraded=(g.degraded.max() if wire_names else
                                     torch.zeros((), dtype=torch.int32,
                                                 device=dev)))
        state.step += 1
        state.last_loss = loss.to(torch.float32)
        return state, metrics

    measure_grads = qcfg.enabled and qcfg.policy.quantizes("grads")
    train_step.placed = True
    train_step.mesh = mesh
    train_step.wire_sync_active = False
    train_step.zero_opt_active = False
    train_step.wire_overlap_active = False
    train_step.zero_groupaligned_active = False
    train_step.guards_active = guards_on
    train_step.wire_buckets = 0
    train_step.qcfg, train_step.transport = qcfg, None
    train_step.n_data = n_data
    return train_step
