"""Step health monitor and the wire's degradation state machine.

Counterpart of ``repro/resilience/guards.py``.  A :class:`GuardState` rides
:class:`~repro_torch.core.qtrain.TrainState` through the step and folds the
step's numeric signals into a small int32 health word:

    bit 0  loss came back NaN/Inf
    bit 1  raw local gradients carried NaN/Inf (counted before the encode:
           the int8 wire writes NaN as the byte 0, so the decoded mean
           looks healthy)
    bit 2  a wire domain's overflow-rate EWMA crossed the storm threshold
    bit 3  the decoded gradient norm spiked against its EWMA (how a
           corrupted wire payload shows: every decoded element gains a
           large power-of-two offset)
    bit 4  a wire domain's FL is pinned at its cap while it clips
           (monitor-only)
    bit 5  a wire domain's IL ratcheted up repeatedly (monitor-only)
    bit 6  at least one wire domain runs the fp32 fallback
    bit 7  this step's update was skipped (params, optimizer state and DPS
           state held)

Everything is computed on the device from values the step already has, and
drained with the other metrics at the log points.  Two differences from the
reference, both forced by eager PyTorch:

* **The skip gate.**  The reference selects the whole new state against the
  old one after the update.  The port updates in place, and a second copy of
  a 3.2 B-parameter state does not fit, so the step computes ``ok`` with
  :func:`step_ok` BEFORE the update (it reads only the loss, the ranks
  with nonfinite gradients, the gradient norm and last step's norm EWMA —
  never the new DPS state) and every in-place write selects leaf by leaf with
  ``torch.where(ok, new, old)``.  With ``ok`` true every select passes the
  new value through bit for bit.
* **The degrade branch.**  The reference switches between the int8 wire and
  its fp32 fallback with a traced ``lax.cond`` on last step's ``degraded``
  flag.  The port reads that flag to the host at the top of a guarded wire
  step (one sync a step) and runs one branch.

:func:`global_norm` sums per-leaf ``vector_norm``s squared (no temporary the
size of a leaf); the reference squares elements.  The two agree to fp32
rounding, which the 16x spike threshold does not see.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import dps as dps_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DpsBundle
from repro_torch.core.fixed_point import QuantStats

HEALTH_LOSS_NONFINITE = 1
HEALTH_GRADS_NONFINITE = 2
HEALTH_OVERFLOW_STORM = 4
HEALTH_GRAD_SPIKE = 8
HEALTH_FL_RAIL = 16
HEALTH_IL_RATCHET = 32
HEALTH_DEGRADED = 64
HEALTH_SKIPPED = 128

_HEALTH_NAMES = (
    (HEALTH_LOSS_NONFINITE, "loss-nonfinite"),
    (HEALTH_GRADS_NONFINITE, "grads-nonfinite"),
    (HEALTH_OVERFLOW_STORM, "overflow-storm"),
    (HEALTH_GRAD_SPIKE, "grad-spike"),
    (HEALTH_FL_RAIL, "fl-rail"),
    (HEALTH_IL_RATCHET, "il-ratchet"),
    (HEALTH_DEGRADED, "degraded"),
    (HEALTH_SKIPPED, "skipped"),
)


def health_flags(word: int) -> Tuple[str, ...]:
    """Decode a drained health word into its event names (host side)."""
    return tuple(name for bit, name in _HEALTH_NAMES if int(word) & bit)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Thresholds of the health monitor; the reference's defaults, far from
    healthy training so that armed guards are transparent."""

    overflow_beta: float = 0.9     # EWMA decay of per-domain overflow rate
    overflow_trip: float = 0.25    # EWMA level that declares a storm
    overflow_trip_hi: float = 0.75 # instantaneous rate that declares one
    spike_ratio: float = 16.0      # gnorm > ratio * EWMA -> corrupted sync
    norm_beta: float = 0.9         # EWMA decay of the gradient norm
    rail_window: int = 8           # consecutive steps before a rail bit
    rail_overflow: float = 0.05    # FL at its cap counts as railed only
                                   # while the domain also clips more
    cooldown: int = 16             # clean steps before int8 re-arms
    widen_on_trip: bool = True     # +1 IL on the compute grads domain


@dataclasses.dataclass(frozen=True)
class GuardState:
    """Per-run health state: device scalars and ``[D]`` vectors, ``D`` the
    plan's wire domains in plan order (:func:`wire_domains`)."""

    health: torch.Tensor         # i32, last step's health word
    trips: torch.Tensor          # i32, cumulative degradation trips
    skipped: torch.Tensor        # i32, cumulative skipped updates
    degraded: torch.Tensor       # i32[D], 1 = fp32 fallback next step
    cooldown: torch.Tensor       # i32[D], clean steps left before re-arm
    overflow_ewma: torch.Tensor  # f32[D]
    gnorm_ewma: torch.Tensor     # f32, EWMA of the decoded gradient norm
    fl_rail: torch.Tensor        # i32[D], consecutive steps FL at its cap
    il_ratchet: torch.Tensor     # i32[D], consecutive steps IL moved up
    prev_il: torch.Tensor        # i32[D], last step's (max) IL per domain


def wire_domains(plan) -> Tuple[str, ...]:
    """The plan's wire domains, in plan order: the ``[D]`` axis."""
    return tuple(n for n, spec in plan.domains if spec.wire)


def init_guard_state(plan, device=None) -> GuardState:
    names = wire_domains(plan)
    d = len(names)
    zi = lambda: torch.zeros((d,), dtype=torch.int32, device=device)
    ils = [spec.make().init(spec.state_shape(), device).il.max()
           .to(torch.int32) for spec in map(plan.spec, names)]
    return GuardState(
        health=torch.zeros((), dtype=torch.int32, device=device),
        trips=torch.zeros((), dtype=torch.int32, device=device),
        skipped=torch.zeros((), dtype=torch.int32, device=device),
        degraded=zi(), cooldown=zi(),
        overflow_ewma=torch.zeros((d,), dtype=torch.float32, device=device),
        gnorm_ewma=torch.zeros((), dtype=torch.float32, device=device),
        fl_rail=zi(), il_ratchet=zi(),
        prev_il=torch.stack(ils) if ils else zi())


def guard_restore_defaults(plan, prefix: str = ".guard") -> dict:
    """Checkpoint defaults for the ``TrainState.guard`` subtree: a guarded
    run resumes from a checkpoint written without guards."""
    from repro_torch.checkpoint import flatten_tree   # checkpoint imports core
    return {f"{prefix}/{k}": v
            for k, v in flatten_tree(init_guard_state(plan)).items()}


def _collapse_stats(ws: QuantStats) -> torch.Tensor:
    """Global overflow rate of a (possibly ``[G]``-shaped) wire-stats leg."""
    return ws.overflow.sum() / torch.clamp(ws.count.sum(), min=1.0)


def domain_overflow(plan, wire_legs: dict, device=None) -> torch.Tensor:
    """f32[D] instantaneous overflow rates, one per wire domain; a domain
    whose leg is absent (or ran the fp32 fallback, zero stats) reads 0."""
    rates = [_collapse_stats(wire_legs[n]) if n in wire_legs
             else torch.zeros((), dtype=torch.float32, device=device)
             for n in wire_domains(plan)]
    return (torch.stack(rates) if rates
            else torch.zeros((0,), dtype=torch.float32, device=device))


def _rail_signals(plan, prev_il, new_dps):
    """``(il, fl_at_cap, il_up)`` per wire domain from the updated DPS
    registry: the max-over-groups IL, whether any group's FL sits at its
    effective cap ``min(fl_max, max_total - il)``, and whether the IL moved
    up against the previous step."""
    ils, caps, ups = [], [], []
    for d, n in enumerate(wire_domains(plan)):
        h = plan.spec(n).hyper
        st = new_dps[n]
        il = st.il.to(torch.int32)
        cap = torch.clamp(h.max_total - il, max=h.fl_max)
        ils.append(il.max())
        caps.append((st.fl.to(torch.int32) >= cap).any())
        ups.append(il.max() > prev_il[d])
    if not ils:
        dev = prev_il.device
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    return torch.stack(ils), torch.stack(caps), torch.stack(ups)


def _fault_signals(gcfg: GuardConfig, guard: GuardState, loss, grads_bad,
                   gnorm):
    loss_bad = ~torch.isfinite(loss)
    g_bad = grads_bad > 0
    # no spike before the norm EWMA has a value; a nonfinite norm never
    # feeds it
    g_ok = torch.isfinite(gnorm)
    spike = g_ok & (guard.gnorm_ewma > 0) & (
        gnorm > gcfg.spike_ratio * guard.gnorm_ewma)
    return loss_bad, g_bad, spike, g_ok


def step_ok(gcfg: GuardConfig, guard: GuardState, *, loss, grads_bad,
            gnorm) -> torch.Tensor:
    """The skip gate (bool device scalar): False when the loss or the raw
    gradients are nonfinite or the gradient norm spiked.  It reads no new
    DPS state, so the step computes it before its in-place update;
    :func:`update_guard` returns the same value."""
    loss_bad, g_bad, spike, _ = _fault_signals(gcfg, guard, loss, grads_bad,
                                               gnorm)
    return ~(loss_bad | g_bad | spike)


def _bit(cond, b: int) -> torch.Tensor:
    return torch.where(cond, b, 0).to(torch.int32)


def update_guard(gcfg: GuardConfig, plan, guard: GuardState, *, loss,
                 grads_bad, gnorm, wire_ov, new_dps,
                 grads_domain_idx: int = 0):
    """Fold this step's signals into the next :class:`GuardState`.

    ``loss`` (the mean over ranks), ``grads_bad`` (> 0 when the RAW local
    gradients of a rank hold a NaN/Inf: :func:`nonfinite_any` summed over
    the ranks), ``gnorm`` (norm of the
    decoded mean gradients), ``wire_ov`` (f32[D] from
    :func:`domain_overflow`) and ``new_dps`` (the registry after the
    controller update, before the gate) are device tensors.
    ``grads_domain_idx``: the ``[D]`` index of the gradient wire, where NaN
    and spike trips land.  Returns ``(new_guard, ok, trip_any)``: ``ok``
    gates the update, ``trip_any`` is this step's rising-edge trip (feeds
    :func:`widen_on_trip`)."""
    i32 = torch.int32
    d = guard.degraded.shape[0]
    dev = guard.health.device
    loss_bad, g_bad, spike, g_ok = _fault_signals(gcfg, guard, loss,
                                                  grads_bad, gnorm)
    ov = torch.where(torch.isfinite(wire_ov), wire_ov, 1.0)
    ov_ewma = (gcfg.overflow_beta * guard.overflow_ewma
               + (1.0 - gcfg.overflow_beta) * ov)
    storm = (ov_ewma > gcfg.overflow_trip) | (ov > gcfg.overflow_trip_hi)

    # per-domain trip: its own storm, plus gradient-path corruption charged
    # to the gradient wire
    grad_fault = loss_bad | g_bad | spike
    if d:
        charge = torch.zeros((d,), dtype=torch.bool, device=dev)
        charge[grads_domain_idx] = grad_fault
        trip = storm | charge
        trip_any = (trip & (guard.degraded == 0)).any()
    else:
        trip = storm
        trip_any = torch.zeros((), dtype=torch.bool, device=dev)

    clean = ~trip
    cooldown = torch.where(
        trip, gcfg.cooldown,
        torch.clamp(guard.cooldown - ((guard.degraded > 0) & clean).to(i32),
                    min=0)).to(i32)
    degraded = torch.where(
        trip, 1, torch.where((guard.degraded > 0) & (cooldown > 0),
                             guard.degraded, 0)).to(i32)

    il, fl_cap, il_up = _rail_signals(plan, guard.prev_il, new_dps)
    # FL at its cap alone is a flexpoint wire format's steady state:
    # railed = pinned AND still clipping
    fl_rail = torch.where(fl_cap & (ov > gcfg.rail_overflow),
                          guard.fl_rail + 1, 0).to(i32)
    il_ratchet = torch.where(il_up, guard.il_ratchet + 1, 0).to(i32)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    railed = (fl_rail >= gcfg.rail_window).any() if d else false
    ratchety = (il_ratchet >= gcfg.rail_window).any() if d else false

    ok = ~(loss_bad | g_bad | spike)
    health = (_bit(loss_bad, HEALTH_LOSS_NONFINITE)
              | _bit(g_bad, HEALTH_GRADS_NONFINITE)
              | _bit(storm.any() if d else false, HEALTH_OVERFLOW_STORM)
              | _bit(spike, HEALTH_GRAD_SPIKE)
              | _bit(railed, HEALTH_FL_RAIL)
              | _bit(ratchety, HEALTH_IL_RATCHET)
              | _bit((degraded > 0).any() if d else false, HEALTH_DEGRADED)
              | _bit(~ok, HEALTH_SKIPPED))

    new_guard = GuardState(
        health=health,
        trips=guard.trips + trip_any.to(i32),
        skipped=guard.skipped + (~ok).to(i32),
        degraded=degraded, cooldown=cooldown,
        overflow_ewma=ov_ewma.to(torch.float32),
        gnorm_ewma=torch.where(ok & g_ok,
                               gcfg.norm_beta * guard.gnorm_ewma
                               + (1.0 - gcfg.norm_beta) * gnorm,
                               guard.gnorm_ewma).to(torch.float32),
        fl_rail=fl_rail, il_ratchet=il_ratchet, prev_il=il)
    return new_guard, ok, trip_any


def select_bundle(ok, new: DpsBundle, old: DpsBundle) -> DpsBundle:
    """``new`` where ``ok`` else ``old``, field by field (exact select)."""
    return DpsBundle(
        (n, dataclasses.replace(new[n], **{
            f.name: torch.where(ok, getattr(new[n], f.name),
                                getattr(old[n], f.name))
            for f in dataclasses.fields(new[n])}))
        for n in new.names())


def widen_on_trip(plan, dps: DpsBundle, trip_any,
                  domain: str = "grads") -> DpsBundle:
    """One IL bit of extra headroom on the compute ``domain`` when a trip
    fired this step, through the controllers' own ``_clamp_fmt``."""
    if domain not in plan:
        return dps
    st = dps[domain]
    il, fl = dps_lib._clamp_fmt(st.il + trip_any.to(torch.int32), st.fl,
                                plan.spec(domain).hyper)
    widened = dataclasses.replace(st, il=il, fl=fl)
    return DpsBundle((n, widened if n == domain else dps[n])
                     for n in dps.names())


def nonfinite_any(tree) -> torch.Tensor:
    """f32 1.0 when a leaf of ``tree`` holds a NaN or an Inf, else 0.0 —
    what the guard reads of the reference's ``nonfinite_count`` (``> 0``).
    One min/max reduction a leaf: a NaN propagates into both, an Inf shows
    as one of them.  ``torch.isfinite`` is composite (``x == x`` and
    ``|x| != inf``, an fp32 temporary the size of its input); at full width
    counting with it cost ~160 ms of device time a step over 4 ranks.
    Rank-local: summed over the ranks it counts the ranks with a nonfinite
    gradient."""
    leaves = [l for l in tree_lib.leaves(tree) if l.numel()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    ext = torch.stack([torch.stack(torch.aminmax(l)).to(torch.float32)
                       for l in leaves])
    return (~torch.isfinite(ext).all()).to(torch.float32)


def global_norm(tree) -> torch.Tensor:
    """f32 L2 norm of a tree (the spike detector's input): the square root
    of the sum of each leaf's squared ``vector_norm``."""
    leaves = tree_lib.leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.square(torch.linalg.vector_norm(
        l, dtype=torch.float32)) for l in leaves))
