"""Quantized-training plumbing: taps, precision-domain registry, train state.

Counterpart of ``repro/core/qtrain.py``: the replicated step and the
int8-wire data-parallel step (``QuantConfig.grad_allreduce_bits`` with a
transport of more than one rank).  ZeRO-1, the overlapped wire and the
health guards wait for later slices (setting their fields raises).  Wires
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
from typing import Any, Dict, Optional

import torch

from repro_torch.core import dps as dps_lib
from repro_torch.core import fixed_point as fxp
from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DpsBundle, DomainSpec, PrecisionPlan
from repro_torch.core.fixed_point import FixedPointFormat, QuantStats, fold_seed
from repro_torch.core.policy import QuantPolicy
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
    # The reference's ZeRO-1, overlap and resilience switches; not ported.
    zero_opt_shards: Optional[int] = None
    wire_overlap: bool = False
    guards: Optional[Any] = None

    def __post_init__(self):
        for name, off in (("zero_opt_shards", None), ("wire_overlap", False),
                          ("guards", None)):
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"QuantConfig.{name}: ZeRO-1, the overlapped wire and "
                    "the health guards are not ported yet")
        if self.backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown quantizer backend {self.backend!r}")

    def plan(self) -> PrecisionPlan:
        """The precision-domain registry this config trains under: one
        domain per compute attribute, plus ``wire_grads`` whenever
        ``grad_allreduce_bits`` is set (gradients start wide, ±2^5, and
        track the bulk two octaves under the max: slack −2)."""
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
        return PrecisionPlan(tuple(domains))

    def with_per_layer_wire(self, params) -> "QuantConfig":
        """This config with one ``wire_grads`` format per leaf of
        ``params`` (a tree of tensors or of anything with the same leaves).
        A no-op unless ``grad_allreduce_bits`` is set."""
        if self.grad_allreduce_bits is None:
            return self
        return dataclasses.replace(
            self, wire_grads_groups=len(tree_lib.leaves(params)))


def init_dps_bundle(qcfg: QuantConfig, device=None) -> DpsBundle:
    """Initial DPS registry: one controller state per declared domain."""
    return qcfg.plan().init(device)


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
                 compute_stats: bool = True):
        """One quantization event under this context's rounding and bit
        source: ``(q, QuantStats | None)``."""
        return ops.dps_quantize(
            x, fmt, ops.event_bits(x, self.rounding, seed, self.onchip_prng),
            compute_stats=compute_stats, backend=self.backend)

    def tap(self, x: torch.Tensor, salt):
        """Quantize activation ``x``; returns ``(q, QuantStats | None)``.

        ``salt`` (an int or a string) decorrelates rounding noise across
        call sites; a layer stack passes the layer index.
        """
        kf = fold_seed(self.seed, salt)
        kb = fold_seed(kf, 0x9E3779B9)
        q, vec = _QTap.apply(x, self, kf, kb)
        return q, (ref_lib.stats_from_vector(vec) if self.collect_stats
                   else None)


class _QTap(torch.autograd.Function):
    """Forward: ``x`` onto the activation grid, with statistics.  Backward:
    the cotangent onto the gradient grid, without.  The statistics come out
    as a non-differentiable ``[7]`` tensor, so a checkpointed block returns
    them instead of recording them on the side (a recompute would record
    them twice)."""

    @staticmethod
    def forward(ctx, x, qctx: QCtx, seed_f: int, seed_b: int):
        q, s = qctx.quantize(x, qctx.acts_fmt, seed_f, compute_stats=True)
        vec = torch.stack([s.count, s.nonzero, s.overflow, s.abs_err_sum,
                           s.rel_err_sum, s.abs_sum, s.max_abs])
        ctx.qctx, ctx.seed_b = qctx, seed_b
        ctx.mark_non_differentiable(vec)
        return q, vec

    @staticmethod
    def backward(ctx, gq, _gvec):
        qctx = ctx.qctx
        g, _ = qctx.quantize(gq, qctx.grads_fmt, ctx.seed_b,
                             compute_stats=False)
        return g, None, None, None


# ---------------------------------------------------------------------------
# Weight / gradient tree quantization.
# ---------------------------------------------------------------------------

def _quantize_tree(tree, fmt, qcfg: QuantConfig, seed: int, inplace: bool):
    return fxp.quantize_tree(tree, fmt, mode=qcfg.rounding, seed=seed,
                             predicate=qcfg.policy.param_predicate(),
                             onchip_prng=qcfg.onchip_prng,
                             backend=qcfg.backend, inplace=inplace)


def quantize_params(params, fmt: FixedPointFormat, qcfg: QuantConfig,
                    seed: int, inplace: bool = False):
    """Snap the parameter tree to the weight grid. Returns (qparams, stats)."""
    if not qcfg.enabled or not qcfg.policy.quantizes("weights"):
        return params, QuantStats.zero(device=fmt.il.device)
    return _quantize_tree(params, fmt, qcfg, seed, inplace)


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

    @staticmethod
    def create(params, opt_state, qcfg: QuantConfig, seed: int,
               device=None) -> "TrainState":
        if device is None:
            device = tree_lib.leaves(params)[0].device
        return TrainState(step=0, params=params, opt_state=opt_state,
                          dps=init_dps_bundle(qcfg, device), seed=seed,
                          last_loss=torch.zeros((), dtype=torch.float32,
                                                device=device))


def make_train_step(loss_fn, optimizer, qcfg: QuantConfig,
                    accum_steps: int = 1, transport=None):
    """Build a quantized SGD/AdamW train step around ``loss_fn``.

    ``loss_fn(params, batch, qctx) -> (loss, aux)`` where ``aux`` is a dict
    that may hold ``"act_stats"`` (merged QuantStats of the taps),
    ``"last_act_stats"`` and ``"dlogits_stats"`` (last-layer statistics).
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
    and backward, its raw-gradient statistics, and the dispatch leg of the
    tree all-reduce (K2b per leaf into its row of the int8 payload; K2 with
    a bits operand unless ``qcfg.onchip_prng``), after
    which its fp32 gradients are dropped; then the rest of the all-reduce
    gives every rank the decoded mean, which goes through the
    optimizer-input quantization and the optimizer as in the replicated
    step.  The wire ⟨IL, FL⟩ comes from the ``wire_grads`` domain, fed by the
    dispatch-leg stats; the grads domain is fed by the compute-grid stats
    of the RAW local gradients (the decoded mean already sits on the wire
    grid: its own stats would starve the controller).  With one rank (or no
    transport) the step is the replicated one, bit for bit.
    ``train_step.wire_sync_active`` says which ran.
    """
    plan = qcfg.plan()
    rounding = getattr(plan.controller("weights"), "rounding", qcfg.rounding)
    wire_bits = qcfg.grad_allreduce_bits
    if wire_bits is not None and not 2 <= wire_bits <= 8:
        raise ValueError(f"grad_allreduce_bits={wire_bits}: the wire payload "
                         "is int8, so only 2..8 grid bits are supported")
    n_data = transport.axis_size if transport is not None else 1
    wire_sync = wire_bits is not None and n_data > 1
    wire_groups = plan.spec("wire_grads").groups if "wire_grads" in plan else 0
    if wire_sync:
        from repro_torch.dist import collectives    # dist imports core

    def _grads(qparams, batch, fmts, seed_a, microbatch_idx):
        qctx = None
        if qcfg.enabled and qcfg.policy.quantizes("acts"):
            qctx = QCtx(acts_fmt=fmts["acts"], grads_fmt=fmts["grads"],
                        seed=fold_seed(seed_a, microbatch_idx),
                        rounding=rounding, collect_stats=True,
                        onchip_prng=qcfg.onchip_prng, backend=qcfg.backend)
        leaves = [leaf.detach().requires_grad_()
                  for leaf in tree_lib.leaves(qparams)]
        loss, aux = loss_fn(tree_lib.from_leaves(qparams, leaves), batch, qctx)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), aux, tree_lib.from_leaves(qparams, list(grads))

    def _accum_grads(qparams, batch, fmts, seed_a):
        if accum_steps == 1:
            return _grads(qparams, batch, fmts, seed_a, 0)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             "microbatches")
        m = n // accum_steps
        loss_acc, g_acc, stats = None, None, None
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
        grads = tree_lib.map_tree(lambda x, p: (x / accum_steps).to(p.dtype),
                                  g_acc, qparams)
        aux = {} if stats is None else {"act_stats": stats}
        return loss_acc / accum_steps, aux, grads

    def _raw_grad_stats(grads, fmts, seed_g, rank):
        """Compute-grid gradient stats measured on the RAW local gradients
        (the reference's ``_raw_grad_stats``): the replicated step's
        gradient quantization event, for its statistics only.  It runs in
        place — the caller has encoded these gradients and drops them.
        Writing q costs the launch nothing: it is bound by the statistics'
        arithmetic, not by its bytes."""
        if not (qcfg.enabled and qcfg.policy.quantizes("grads")):
            return QuantStats.zero(device=fmts["grads"].il.device)
        _, st = quantize_grads(grads, fmts["grads"], qcfg,
                               fold_seed(seed_g, rank), inplace=True)
        return st

    def _wire_synced_grads(qparams, batch, fmts, seed_a, seed_g, seed_r):
        """Per-rank forward/backward + the dispatch leg of the int8 tree
        all-reduce, rank by rank; returns the per-rank losses, aux dicts
        and raw-gradient stats, and the all-reduce to finish."""
        n = next(iter(batch.values())).shape[0]
        if n % n_data:
            raise ValueError(f"batch {n} does not split into {n_data} "
                             "data-parallel ranks")
        m = n // n_data
        n_leaves = len(tree_lib.leaves(qparams))
        if wire_groups and n_leaves != wire_groups:
            raise ValueError(
                f"wire_grads_groups={wire_groups} but the gradient tree has "
                f"{n_leaves} leaves; per-layer wire formats need one group "
                "per leaf (derive the config with "
                "QuantConfig.with_per_layer_wire(params))")
        tw = collectives.TreeAllReduce(qparams, fmts, transport, seed_r,
                                       mode=rounding, domain="wire_grads",
                                       backend=qcfg.backend,
                                       onchip_prng=qcfg.onchip_prng)
        losses, auxes, raws = [], [], []
        for r in transport.ranks:
            rows = {k: v[r * m:(r + 1) * m] for k, v in batch.items()}
            loss, aux, grads = _accum_grads(qparams, rows, fmts,
                                            fold_seed(seed_a, r))
            tw.encode(r, grads)
            raws.append(_raw_grad_stats(grads, fmts, seed_g, r))
            del grads
            losses.append(loss)
            auxes.append(aux)
        return losses, auxes, raws, tw

    def _pmean(values):
        return transport.psum(torch.stack(values)) / n_data

    def train_step(state: TrainState, batch):
        dev = state.last_loss.device
        # counterpart of split(fold_in(rng, step), 3)
        seed_w, seed_g, seed_a = (fold_seed(state.seed, state.step, k)
                                  for k in range(3))
        fmts = bundle_formats(qcfg, state.dps)

        # -- forward/backward in the quantized regime (Alg. 1 lines 9-20) --
        qparams, w_stats = quantize_params(state.params, fmts["weights"],
                                           qcfg, seed_w)
        wire_stats = None
        if wire_sync:
            # the wire path derives its own stream instead of widening the
            # step's split, so the replicated path keeps its seeds
            seed_r = fold_seed(state.seed, state.step, _WIRE_SALT)
            losses, auxes, raws, tw = _wire_synced_grads(
                qparams, batch, fmts, seed_a, seed_g, seed_r)
            del qparams
            grads, wstats = tw.finish()
            del tw
            wire_stats = collectives.psum_stats(wstats, transport)
            loss = _pmean(losses)
            aux = {k: (collectives.psum_stats([a[k] for a in auxes], transport)
                       if isinstance(v, QuantStats)
                       else _pmean([a[k] for a in auxes]))
                   for k, v in auxes[0].items()}
            # the optimizer-input snap still applies (Alg. 1); the grads
            # controller reads the raw-gradient measurement instead
            grads, _ = quantize_grads(grads, fmts["grads"], qcfg, seed_g,
                                      inplace=True)
            g_stats = collectives.psum_stats(raws, transport)
        else:
            loss, aux, grads = _accum_grads(qparams, batch, fmts, seed_a)
            del qparams
            grads, g_stats = quantize_grads(grads, fmts["grads"], qcfg,
                                            seed_g, inplace=True)
        # -- update (Alg. 1 line 18), in place --
        optimizer.update(grads, state.opt_state, state.params,
                         count=state.step)
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
        if qcfg.enabled and qcfg.policy.quantizes("weights"):
            _, w_stats2 = quantize_params(state.params, fmts["weights"], qcfg,
                                          fold_seed(seed_w, 1), inplace=True)
            w_stats = w_stats.merge(w_stats2)

        # -- scale_precision (Alg. 2, one controller per domain); the wire
        # leg feeds its own domain, never a compute controller --
        streams = {"weights": w_stats, "acts": a_stats, "grads": g_stats}
        if wire_stats is not None:
            streams["wire_grads"] = wire_stats
        state.dps = update_dps_bundle(qcfg, state.dps, streams,
                                      {"loss": loss})

        # -- telemetry: ⟨IL, FL⟩ + E/R per domain (a per-group domain is
        # reported by its mean, and its formats' min and max) --
        short = {"weights": "w", "acts": "a", "grads": "g"}
        metrics = {"loss": loss}
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
        if wire_stats is not None:
            ws = wire_stats
            if ws.count.ndim:          # [G] per-layer stats -> global view
                ws = QuantStats(*(f.sum() for f in (
                    ws.count, ws.nonzero, ws.overflow, ws.abs_err_sum,
                    ws.rel_err_sum, ws.abs_sum)), max_abs=ws.max_abs.max())
            metrics["E_wire"] = ws.quant_error()
            metrics["R_wire"] = ws.overflow_rate()
        state.step += 1
        state.last_loss = loss.to(torch.float32)
        return state, metrics

    train_step.wire_sync_active = wire_sync
    train_step.n_data = n_data
    return train_step
