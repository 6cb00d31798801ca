"""Quantized-training plumbing: taps, precision-domain registry, train state.

Counterpart of ``repro/core/qtrain.py``, **replicated (one-device) step
only**: the compressed gradient all-reduce, ZeRO-1, the overlapped wire and
the health guards wait for later slices (setting their fields raises).
Wires the paper's Algorithm 1 into a PyTorch model:

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
    # handed to it as an operand (K1, the reference's default).
    onchip_prng: bool = True
    # Quantizer backend: "auto" (kernel on CUDA tensors, plain version on
    # CPU tensors), "kernel", or "plain" (to hold the kernel to its plain
    # version on the card).
    backend: str = "auto"
    # The reference's distributed and resilience switches; not ported yet.
    grad_allreduce_bits: Optional[int] = None
    zero_opt_shards: Optional[int] = None
    wire_overlap: bool = False
    guards: Optional[Any] = None

    def __post_init__(self):
        for name, off in (("grad_allreduce_bits", None),
                          ("zero_opt_shards", None), ("wire_overlap", False),
                          ("guards", None)):
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"QuantConfig.{name}: the int8 wire, ZeRO-1 and the health "
                    "guards are not ported yet (replicated step only)")
        if self.backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown quantizer backend {self.backend!r}")

    def plan(self) -> PrecisionPlan:
        """The precision-domain registry this config trains under: one
        domain per compute attribute."""
        return PrecisionPlan((
            ("weights", DomainSpec(self.controller, self.hyper_weights)),
            ("acts", DomainSpec(self.controller, self.hyper_acts)),
            ("grads", DomainSpec(self.controller, self.hyper_grads)),
        ))


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
                    accum_steps: int = 1):
    """Build a quantized SGD/AdamW train step around ``loss_fn``.

    ``loss_fn(params, batch, qctx) -> (loss, aux)`` where ``aux`` is a dict
    that may hold ``"act_stats"`` (merged QuantStats of the taps),
    ``"last_act_stats"`` and ``"dlogits_stats"`` (last-layer statistics).
    Returns ``step(state, batch) -> (state, metrics)``; the state is
    advanced in place and returned, the metrics are device tensors (reading
    them is the caller's host sync).

    ``accum_steps > 1`` splits the batch into microbatches run one after
    the other with fp32 gradient accumulation.
    """
    plan = qcfg.plan()
    rounding = getattr(plan.controller("weights"), "rounding", qcfg.rounding)

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

    def train_step(state: TrainState, batch):
        dev = state.last_loss.device
        # counterpart of split(fold_in(rng, step), 3)
        seed_w, seed_g, seed_a = (fold_seed(state.seed, state.step, k)
                                  for k in range(3))
        fmts = bundle_formats(qcfg, state.dps)

        # -- forward/backward in the quantized regime (Alg. 1 lines 9-20) --
        qparams, w_stats = quantize_params(state.params, fmts["weights"],
                                           qcfg, seed_w)
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

        # -- scale_precision (Alg. 2, one controller per domain) --
        streams = {"weights": w_stats, "acts": a_stats, "grads": g_stats}
        state.dps = update_dps_bundle(qcfg, state.dps, streams,
                                      {"loss": loss})

        # -- telemetry: ⟨IL, FL⟩ + E/R per domain --
        short = {"weights": "w", "acts": "a", "grads": "g"}
        metrics = {"loss": loss}
        for name, spec in plan.domains:
            fmt, tag = fmts[name], short.get(name, name)
            metrics[f"il_{tag}"] = fmt.il
            metrics[f"fl_{tag}"] = fmt.fl
            st = streams.get(spec.stream(name))
            if st is not None:
                metrics[f"E_{tag}"] = st.quant_error()
                metrics[f"R_{tag}"] = st.overflow_rate()
        state.step += 1
        state.last_loss = loss.to(torch.float32)
        return state, metrics

    return train_step
