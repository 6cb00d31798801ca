"""Dynamic precision scaling controllers and the precision-domain registry.

Counterpart of ``repro/core/dps.py``.  A controller is a pure state machine
on device tensors:

    state  = controller.init(shape, device)         # dataclass of tensors
    state  = controller.update(state, stats, aux)   # once per step
    fmt    = controller.fmt(state)                  # FixedPointFormat to use

``stats`` is the merged :class:`~repro_torch.core.fixed_point.QuantStats` of
the **precision domain** the controller governs.  Domains are declared by a
:class:`PrecisionPlan` (domain name -> :class:`DomainSpec`) which builds the
named :class:`DpsBundle` registry.

All updates are branchless tensor arithmetic on int32 state — no ``.item()``,
no host synchronisation.

Ported: the paper's Algorithm 2 controller, the Courbariaux, Na &
Mukhopadhyay, static and FlexPoint-like baselines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import tagging
from repro_torch.core.fixed_point import FixedPointFormat, QuantStats

# fp32-mantissa exactness bound for the emulation grid: IL - 1 + FL <= 24.
_EXACT_SPAN = 24


@dataclasses.dataclass(frozen=True)
class DPSHyper:
    """Static controller hyper-parameters (hashable).

    Defaults follow the paper's evaluation (§4): thresholds
    ``E_max = R_max = 0.01% = 1e-4``, updated once per iteration.
    """

    r_max: float = 1e-4
    e_max: float = 1e-4
    il_min: int = 2
    il_max: int = 16
    fl_min: int = 0
    fl_max: int = 23
    il_init: int = 8
    fl_init: int = 12
    step: int = 1                      # unit bit step `s`
    total_bits: int = 16               # fixed-width schemes (Courbariaux/FlexPoint)
    max_total: int = 32                # dynamic-width cap (IL+FL)
    error_metric: str = "relative_mean"
    # Na & Mukhopadhyay convergence baseline:
    na_ml: int = 24
    na_tl_init: int = 8
    na_window: int = 100
    na_eps: float = 1e-3
    # FlexPoint-like predictive scheme:
    flex_decay: float = 0.9
    flex_slack: float = 1.0            # extra headroom bits on predicted max
    # measured-slack mode (wire domains): place the radix at the r_max tail
    # quantile of the measured magnitude distribution
    flex_auto_slack: bool = False


def _clamp_fmt(il: torch.Tensor, fl: torch.Tensor, h: DPSHyper):
    il = il.clamp(h.il_min, h.il_max)
    fl = fl.clamp(h.fl_min, h.fl_max)
    # keep the emulation grid exact in fp32 and respect the width cap:
    # shrink FL first (overflow is the catastrophic failure mode)
    fl = torch.minimum(fl, _EXACT_SPAN + 1 - il)
    fl = torch.minimum(fl, h.max_total - il)
    return il.to(torch.int32), fl.to(torch.int32)


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Paper controller — Algorithm 2.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaperState:
    il: torch.Tensor
    fl: torch.Tensor


class PaperController:
    """Overflow- and quantization-error-based scaling (the paper's Alg. 2).

        if R > R_max: IL += s  else IL -= s
        if E > E_max: FL += s  else FL -= s

    Aggressive by design: width shrinks on *every* step where the metrics sit
    below threshold.
    """

    name = "paper"

    def __init__(self, hyper: DPSHyper = DPSHyper()):
        self.h = hyper

    def init(self, shape=(), device=None) -> PaperState:
        return PaperState(il=_full(shape, self.h.il_init, torch.int32, device),
                          fl=_full(shape, self.h.fl_init, torch.int32, device))

    def fmt(self, state: PaperState) -> FixedPointFormat:
        return FixedPointFormat(state.il, state.fl)

    def update(self, state: PaperState, stats: QuantStats, aux=None) -> PaperState:
        h = self.h
        r = stats.overflow_rate()
        e = stats.quant_error(h.error_metric)
        il = state.il + torch.where(r > h.r_max, h.step, -h.step)
        fl = state.fl + torch.where(e > h.e_max, h.step, -h.step)
        return PaperState(*_clamp_fmt(il, fl, h))


# ---------------------------------------------------------------------------
# Courbariaux et al. '14 — fixed width, dynamic radix, overflow-driven.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CourbariauxState:
    il: torch.Tensor
    fl: torch.Tensor


class CourbariauxController:
    """Greedy overflow-rate scheme with IL + FL = total_bits.

    if R > R_max:        radix right (IL+1, FL-1)
    elif 2R <= R_max:    radix left  (IL-1, FL+1)   # headroom
    else:                unchanged
    """

    name = "courbariaux"

    def __init__(self, hyper: DPSHyper = DPSHyper()):
        self.h = hyper

    def init(self, shape=(), device=None) -> CourbariauxState:
        n = self.h.total_bits
        il0 = min(max(self.h.il_init, self.h.il_min), n - 1)
        return CourbariauxState(il=_full(shape, il0, torch.int32, device),
                                fl=_full(shape, n - il0, torch.int32, device))

    def fmt(self, state: CourbariauxState) -> FixedPointFormat:
        return FixedPointFormat(state.il, state.fl)

    def update(self, state: CourbariauxState, stats: QuantStats, aux=None):
        h = self.h
        r = stats.overflow_rate()
        delta = torch.where(r > h.r_max, 1, torch.where(2.0 * r <= h.r_max, -1, 0))
        il = (state.il + delta).clamp(h.il_min, h.total_bits - h.fl_min)
        fl = h.total_bits - il
        return CourbariauxState(il.to(torch.int32), fl.to(torch.int32))


# ---------------------------------------------------------------------------
# Na & Mukhopadhyay '16 — convergence-based, dynamic width (round-to-nearest).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NaState:
    tl: torch.Tensor          # current target bit-width
    il: torch.Tensor
    fl: torch.Tensor
    loss_ema: torch.Tensor    # slow EMA of training loss
    best_ema: torch.Tensor    # best (lowest) EMA seen since last width bump
    stall: torch.Tensor       # consecutive non-improving steps


class NaController:
    """Width grows by `s` whenever training stalls or overflows.

    IL tracks overflow like the fixed-width schemes; FL = tl - IL.  Rounding
    is round-to-nearest in the original — the train step consults
    ``controller.rounding`` to pick the mode.
    """

    name = "na_mukhopadhyay"
    rounding = "nearest"

    def __init__(self, hyper: DPSHyper = DPSHyper()):
        self.h = hyper

    def init(self, shape=(), device=None) -> NaState:
        tl0 = self.h.na_tl_init
        il0 = max(self.h.il_min, tl0 // 2)
        inf = float("inf")
        return NaState(tl=_full(shape, tl0, torch.int32, device),
                       il=_full(shape, il0, torch.int32, device),
                       fl=_full(shape, tl0 - il0, torch.int32, device),
                       loss_ema=_full(shape, inf, torch.float32, device),
                       best_ema=_full(shape, inf, torch.float32, device),
                       stall=_full(shape, 0, torch.int32, device))

    def fmt(self, state: NaState) -> FixedPointFormat:
        return FixedPointFormat(state.il, state.fl)

    def update(self, state: NaState, stats: QuantStats, aux=None) -> NaState:
        h = self.h
        dev = state.il.device
        loss = (torch.as_tensor(aux["loss"], dtype=torch.float32, device=dev)
                if aux else torch.zeros((), dtype=torch.float32, device=dev))
        beta = 1.0 - 1.0 / h.na_window
        ema = torch.where(torch.isinf(state.loss_ema), loss,
                          beta * state.loss_ema + (1 - beta) * loss)
        improved = ema < state.best_ema * (1.0 - h.na_eps)
        stall = torch.where(improved, 0, state.stall + 1)
        stagnant = stall >= h.na_window
        overflowing = stats.overflow_rate() > h.r_max
        bump = stagnant | overflowing
        tl = (state.tl + torch.where(bump, h.step, 0)).clamp(h.na_tl_init,
                                                            h.na_ml)
        # radix placement from overflow, width from convergence
        il = torch.minimum(torch.maximum(state.il + overflowing.to(torch.int32),
                                         torch.full_like(tl, h.il_min)),
                           tl - h.fl_min)
        fl = tl - il
        return NaState(
            tl=tl.to(torch.int32), il=il.to(torch.int32), fl=fl.to(torch.int32),
            loss_ema=ema,
            best_ema=torch.where(improved, ema,
                                 torch.where(bump, ema, state.best_ema)),
            stall=torch.where(bump, 0, stall).to(torch.int32))


# ---------------------------------------------------------------------------
# Gupta et al. '15 — static format (no scaling).
# ---------------------------------------------------------------------------

class StaticController:
    """Fixed ⟨IL, FL⟩ for the whole run (Gupta et al.; also the paper's
    "fixed 13-bit" divergence demonstration)."""

    name = "static"

    def __init__(self, hyper: DPSHyper = DPSHyper()):
        self.h = hyper

    def init(self, shape=(), device=None) -> PaperState:
        return PaperState(il=_full(shape, self.h.il_init, torch.int32, device),
                          fl=_full(shape, self.h.fl_init, torch.int32, device))

    def fmt(self, state: PaperState) -> FixedPointFormat:
        return FixedPointFormat(state.il, state.fl)

    def update(self, state: PaperState, stats: QuantStats, aux=None) -> PaperState:
        return state


# ---------------------------------------------------------------------------
# FlexPoint-like — fixed width, predictive max-value radix (Köster et al.).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlexState:
    il: torch.Tensor
    fl: torch.Tensor
    max_ema: torch.Tensor


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``ceil(log2(x))`` as int32 for positive normal float32 ``x``,
    read from the float's bits: the unbiased exponent, plus one when any
    mantissa bit is set.  The same on every device.  A float32 library
    ``log2`` is not: just above 2^k its result rounds down to ``k`` from
    k = 4 on (and from k = 3 in some libraries), which would place the radix
    one bit short of covering the value."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    exp = ((b >> 23) & 0xFF) - 127
    return exp + ((b & 0x7FFFFF) != 0).to(torch.int32)


class FlexpointController:
    """Predict next-step max |x| from an EMA, place the radix just above it.

    Width is fixed at ``total_bits``.
    """

    name = "flexpoint"

    def __init__(self, hyper: DPSHyper = DPSHyper()):
        self.h = hyper

    def init(self, shape=(), device=None) -> FlexState:
        n = self.h.total_bits
        il0 = min(max(self.h.il_init, self.h.il_min), n)
        return FlexState(
            il=torch.full(shape, il0, dtype=torch.int32, device=device),
            fl=torch.full(shape, n - il0, dtype=torch.int32, device=device),
            max_ema=torch.zeros(shape, dtype=torch.float32, device=device),
        )

    def fmt(self, state: FlexState) -> FixedPointFormat:
        return FixedPointFormat(state.il, state.fl)

    def update(self, state: FlexState, stats: QuantStats, aux=None) -> FlexState:
        h = self.h
        m = torch.maximum(h.flex_decay * state.max_ema,
                          stats.max_abs.to(torch.float32))
        pred = m * (2.0 ** h.flex_slack)
        if h.flex_auto_slack:
            # Measured slack: mean |x| over nonzero elements estimates the
            # bulk scale b; for a Laplace(0, b) tail the r_max quantile sits
            # at b·ln(1/r_max).  Never place above the max component, and
            # fall back to the static slack when the stream carried no stats.
            bulk = stats.abs_sum / stats.nonzero.clamp(min=1.0)
            cover = bulk * float(torch.tensor(1.0 / h.r_max,
                                              dtype=torch.float32).log())
            pred = torch.where(stats.nonzero > 0.0,
                               torch.minimum(m, cover), pred)
        # smallest IL whose signed range covers pred: 2^(IL-1) > pred
        il = _ceil_log2(pred.clamp(min=1e-30)) + 1
        il = il.clamp(h.il_min, h.total_bits - h.fl_min)
        fl = h.total_bits - il
        return FlexState(il.to(torch.int32), fl.to(torch.int32), m)


CONTROLLERS = {
    c.name: c
    for c in (PaperController, CourbariauxController, NaController,
              StaticController, FlexpointController)
}


def make_controller(name: str, hyper: Optional[DPSHyper] = None):
    if name not in CONTROLLERS:
        raise ValueError(f"unknown DPS controller {name!r}; have "
                         f"{sorted(CONTROLLERS)}")
    return CONTROLLERS[name](hyper or DPSHyper())


def wire_hyper(wire_bits: int, il_init: int, slack: float = 1.0,
               auto_slack: bool = False) -> DPSHyper:
    """Hyper-parameters for a *wire* precision domain.

    The wire payload is int8 grid integers, so every width knob is capped at
    ``wire_bits``: fixed-width controllers run at ``total_bits = wire_bits``
    and dynamic-width ones are clamped by ``max_total = wire_bits``.

    ``slack`` is the flexpoint headroom exponent (radix placed to cover
    ``max|x| · 2^slack``); ``auto_slack=True`` replaces it with a placement
    measured from the stream's own ``abs_sum``/``nonzero`` at the ``r_max``
    tail quantile, with ``slack`` as the fallback until the stream first
    carries stats.
    """
    il0 = min(max(il_init, 1), wire_bits)
    return DPSHyper(il_min=1, il_max=wire_bits, fl_min=0,
                    fl_max=max(wire_bits - 1, 1), il_init=il0,
                    fl_init=wire_bits - il0, total_bits=wire_bits,
                    max_total=wire_bits, flex_slack=slack,
                    flex_auto_slack=auto_slack)


# ---------------------------------------------------------------------------
# Precision domains: declarative plan -> named controller-state registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """One precision domain: controller kind, hyper, stats routing, groups.

    ``stats`` names the :class:`QuantStats` stream that feeds this domain's
    controller (empty = the domain's own name).  ``groups`` > 0 declares a
    per-group ``[G]`` controller state — one ⟨IL, FL⟩ per group, the
    ``[G, 2]`` format table the grouped wire kernel consumes; 0 is the
    global scalar case.  ``wire`` declares a *wire* domain: its controller
    consumes wire-leg ``QuantStats``.
    """

    controller: str = "paper"
    hyper: DPSHyper = DPSHyper()
    stats: str = ""
    groups: int = 0
    wire: bool = False

    def make(self):
        return make_controller(self.controller, self.hyper)

    def state_shape(self) -> tuple:
        return (self.groups,) if self.groups else ()

    def stream(self, name: str) -> str:
        return self.stats or name


class DpsBundle:
    """Named per-domain controller states: an ordered, immutable mapping
    ``{domain: controller state}``."""

    def __init__(self, states):
        self._states = dict(states)

    def __getitem__(self, name):
        return self._states[name]

    def __contains__(self, name):
        return name in self._states

    def __iter__(self):
        return iter(self._states)

    def __len__(self):
        return len(self._states)

    def __repr__(self):
        return f"DpsBundle({list(self._states)})"

    def names(self):
        return tuple(self._states)

    def items(self):
        return self._states.items()


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Declarative registry: domain name -> :class:`DomainSpec`.

        plan   = PrecisionPlan.of(weights=DomainSpec(...), ...)
        bundle = plan.init(device)                # DpsBundle
        fmts   = plan.formats(bundle)             # {domain: FixedPointFormat}
        bundle = plan.update(bundle, streams, aux)

    ``streams`` is a ``{stream name: QuantStats}`` dict; each domain consumes
    the stream its spec routes to (its own name by default) and sees zero
    stats when that stream is absent this step.
    """

    domains: Tuple[Tuple[str, DomainSpec], ...]

    def __post_init__(self):
        names = [n for n, _ in self.domains]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate precision domains in {names}")
        for n, spec in self.domains:
            if spec.controller not in CONTROLLERS:
                raise ValueError(f"domain {n!r}: unknown controller "
                                 f"{spec.controller!r}")
            if spec.groups < 0:
                raise ValueError(f"domain {n!r}: groups must be >= 0")

    @staticmethod
    def of(**domains: DomainSpec) -> "PrecisionPlan":
        return PrecisionPlan(tuple(domains.items()))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.domains)

    def spec(self, name: str) -> DomainSpec:
        for n, s in self.domains:
            if n == name:
                return s
        raise KeyError(f"no precision domain {name!r}; have {self.names}")

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.domains)

    def controller(self, name: str):
        return self.spec(name).make()

    def init(self, device=None) -> DpsBundle:
        return DpsBundle((n, s.make().init(s.state_shape(), device))
                         for n, s in self.domains)

    def formats(self, bundle: DpsBundle):
        return {n: s.make().fmt(bundle[n]) for n, s in self.domains}

    def update(self, bundle: DpsBundle, streams, aux=None) -> DpsBundle:
        out = {}
        for n, s in self.domains:
            st = streams.get(s.stream(n))
            shape = s.state_shape()
            if st is None:
                st = QuantStats.zero(shape, bundle[n].il.device)
            elif tuple(st.count.shape) != shape:
                if st.count.ndim == 0:
                    # a scalar stream feeding a per-group domain drives
                    # every group with the same global statistics
                    st = QuantStats(*(getattr(st, f.name).expand(shape)
                                      for f in dataclasses.fields(st)))
                else:
                    raise ValueError(
                        f"domain {n!r} (groups={s.groups}) consumes stream "
                        f"{s.stream(n)!r} whose stats have shape "
                        f"{tuple(st.count.shape)}; a routed stream must be "
                        "scalar or match the domain's group count")
            # the consumption site, for the precision-flow verifier: this
            # stream is about to drive domain n's controller
            tagging.tag_tree(st, "stats_sink", domain=n, wire=s.wire,
                             stream=s.stream(n))
            out[n] = s.make().update(bundle[n], st, aux)
        return DpsBundle(out)
