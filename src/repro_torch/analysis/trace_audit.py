"""Byte and dtype audit of a recorded step: the wire claims per config.

Counterpart of ``repro/analysis/hlo_audit.py``, with its seven rules and
their IDs.  The reference proves them on the HLO XLA compiled; the port on
what a run executed: the collective nodes the transports recorded (dtype
and one rank's bytes, :mod:`repro_torch.launch.trace_stats`), the ``cat``
ops the dispatcher saw, and the sizes of every tensor the step touched.

``HA-PAYLOAD-DTYPE``
    In a step with an engaged wire domain every all-to-all byte is int8,
    and a two-leg gradient wire shows int8 all-gather bytes.

``HA-DOMAIN-COVERAGE``
    Every engaged wire domain has an int8 payload on its collective
    (``wire_grads`` -> all-to-all, ``wire_params`` -> all-gather).  A domain
    the claims put on the fp32 fallback this step (``fallback``, a degraded
    step of the health guards) must have none.

``HA-F32-RESIDUAL``
    fp32 collective bytes stay under ``f32_residual_frac`` of the ring-model
    fp32 all-reduce a wire-less step would pay (``2 × 4 × n_wire_elems``)
    plus the declared fp32 bytes (the ZeRO fp32 params leg; a degraded
    step's fallback).

``HA-WIRE-RATIO``
    int8 wire bytes sit within ``wire_ratio_bounds`` of ``legs ×
    n_wire_elems``.

``HA-F32-CONCAT``
    The wire pipeline run on its own concatenates no more than
    ``f32_concat_budget`` fp32 bytes.

``HA-KV-DTYPE`` / ``HA-KV-F32-CACHE`` (:func:`audit_decode_trace`)
    A paged decode step at ``kv_bits=8`` touches an int8 tensor at least as
    large as one stacked page pool, and no fp32 tensor that large.

**One branch a run.**  XLA compiles both branches of a guarded wire (the
int8 legs and the fp32 fallback), so the reference's guarded claims declare
the fallback's bytes as capacity.  An eager step runs one branch: the lint
audits a clean guarded step against the int8 claims and a degraded step (a
NaN drill) against ``fallback`` claims.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.analysis.report import Report
from repro_torch.launch.trace_stats import (collective_wire_bytes,
                                            concat_bytes, largest_tensors)

# which collective op serves each wire domain's payload
DOMAIN_PAYLOAD_OPS: Dict[str, Tuple[str, ...]] = {
    "wire_grads": ("all-to-all",),
    "wire_params": ("all-gather",),
}


@dataclasses.dataclass(frozen=True)
class AuditClaims:
    """What a config promises its step's traffic looks like.

    ``engaged``: the wire domains the step drives on its int8 legs;
    ``fallback``: those it runs on the fp32 fallback this step (a degraded
    step).  ``two_leg``: the all-reduce schedule (dispatch + gather) as
    opposed to the ZeRO halves.  ``n_wire_elems`` sizes the ratio and
    residual bounds (None skips them)."""

    engaged: Tuple[str, ...] = ()
    fallback: Tuple[str, ...] = ()
    two_leg: bool = True
    grouped: bool = False
    n_wire_elems: Optional[int] = None
    wire_ratio_bounds: Tuple[float, float] = (0.5, 3.0)
    f32_residual_frac: float = 0.02
    f32_declared_bytes: float = 0.0
    f32_concat_budget: float = 0.0


def audit_trace(trace, claims: AuditClaims, name: str = "trace") -> Report:
    """Evaluate every HA rule the claims make checkable."""
    report = Report(name=name)
    wire = collective_wire_bytes(trace)
    by_op = wire["by_op_dtype"]
    by_dtype = wire["by_dtype"]

    def op_dtype(op: str, dtype: str) -> float:
        return by_op.get(op, {}).get(dtype, 0.0)

    def op_total(op: str, *dtypes: str) -> float:
        d = by_op.get(op, {})
        return sum(v for k, v in d.items() if not dtypes or k in dtypes)

    int8_total = by_dtype.get("s8", 0.0) + by_dtype.get("u8", 0.0)

    if claims.engaged:
        report.mark_checked("HA-PAYLOAD-DTYPE", "HA-DOMAIN-COVERAGE")
        bad_a2a = op_total("all-to-all") - op_total("all-to-all", "s8", "u8")
        if bad_a2a > 0:
            report.add(
                "HA-PAYLOAD-DTYPE",
                f"{bad_a2a:.0f} non-int8 all-to-all bytes "
                f"({by_op.get('all-to-all')}) — the dispatch leg must ship "
                f"s8 grid integers only", name)
        if claims.two_leg and "wire_grads" in claims.engaged \
                and op_dtype("all-gather", "s8") == 0.0:
            report.add(
                "HA-PAYLOAD-DTYPE",
                "two-leg gradient wire engaged but no s8 all-gather bytes "
                "in the step — the gather leg is missing or fp32", name)
        for dom in claims.engaged:
            ops = DOMAIN_PAYLOAD_OPS.get(dom)
            if ops is None:
                report.add("HA-DOMAIN-COVERAGE",
                           f"unknown wire domain {dom!r} has no payload-op "
                           f"mapping", name)
                continue
            served = sum(op_dtype(op, "s8") + op_dtype(op, "u8")
                         for op in ops)
            if served == 0.0:
                report.add(
                    "HA-DOMAIN-COVERAGE",
                    f"domain {dom!r} is engaged but the step has no int8 "
                    f"{'/'.join(ops)} payload — the declared wire never "
                    f"materialized", name)
    if claims.fallback:
        report.mark_checked("HA-DOMAIN-COVERAGE")
        for dom in claims.fallback:
            served = sum(op_dtype(op, "s8") + op_dtype(op, "u8")
                         for op in DOMAIN_PAYLOAD_OPS.get(dom, ()))
            if served:
                report.add(
                    "HA-DOMAIN-COVERAGE",
                    f"domain {dom!r} is on its fp32 fallback this step but "
                    f"{served:.0f} int8 payload bytes still ride its "
                    f"collective — the degrade branch did not engage", name)

    if (claims.engaged or claims.fallback) and claims.n_wire_elems:
        report.mark_checked("HA-F32-RESIDUAL")
        f32_ref = 2.0 * 4.0 * claims.n_wire_elems
        f32 = by_dtype.get("f32", 0.0)
        budget = claims.f32_declared_bytes \
            + claims.f32_residual_frac * f32_ref
        if f32 > budget:
            report.add(
                "HA-F32-RESIDUAL",
                f"{f32:.0f} fp32 collective bytes vs a "
                f"{claims.f32_residual_frac:.0%}-of-{f32_ref:.0f}-B "
                f"residual budget (+ {claims.f32_declared_bytes:.0f} B "
                f"declared) — an uncompressed tensor is riding the "
                f"interconnect", name)
    if claims.engaged and claims.n_wire_elems:
        report.mark_checked("HA-WIRE-RATIO")
        legs = 2.0 if claims.two_leg else 1.0
        ideal = legs * claims.n_wire_elems
        lo, hi = claims.wire_ratio_bounds
        if not (lo * ideal <= int8_total <= hi * ideal):
            report.add(
                "HA-WIRE-RATIO",
                f"{int8_total:.0f} int8 wire bytes outside "
                f"[{lo:.2g}, {hi:.2g}] × ideal {ideal:.0f} B "
                f"({legs:.0f} leg(s) × {claims.n_wire_elems} elems) — a "
                f"missing leg or a padding blow-up", name)

    if claims.grouped:
        report.mark_checked("HA-F32-CONCAT")
        f32_cat = concat_bytes(trace)["by_dtype"].get("f32", 0.0)
        if f32_cat > claims.f32_concat_budget:
            report.add(
                "HA-F32-CONCAT",
                f"{f32_cat:.0f} fp32 concatenate bytes (budget "
                f"{claims.f32_concat_budget:.0f}) — leaves are being "
                f"flattened through an fp32 intermediate instead of "
                f"encoding straight into the int8 buffer", name)
    return report


def audit_decode_trace(trace, *, pool_elems: int, bits,
                       name: str = "serve-decode") -> Report:
    """Serving-side claims on a recorded paged decode step.

    ``pool_elems``: the element count of ONE stacked page pool (K or V:
    ``n_layers · n_pages_total · page_size · kv_heads · head_dim``), the
    size scale that separates the cache from everything else the step
    touches.  ``bits``: the engine's ``kv_bits`` (8 or None)."""
    report = Report(name=name)
    sizes = largest_tensors(trace)
    if bits == 8:
        report.mark_checked("HA-KV-DTYPE", "HA-KV-F32-CACHE")
        big_i8 = max(sizes.get("s8", 0), sizes.get("u8", 0))
        if big_i8 < pool_elems:
            report.add(
                "HA-KV-DTYPE",
                f"pool holds {pool_elems} elements but the largest int8 "
                f"tensor the decode step touches has {big_i8} — the paged "
                f"KV cache is not stored as int8 grid integers", name)
        if sizes.get("f32", 0) >= pool_elems:
            report.add(
                "HA-KV-F32-CACHE",
                f"a {sizes['f32']}-element f32 tensor (>= the "
                f"{pool_elems}-element pool) appears in the decode step — "
                f"int8 pages are being dequantized into a materialized "
                f"fp32 cache instead of in-register", name)
    return report
