"""Dataflow pass: taint propagation from the declared landmarks of a step.

Counterpart of ``repro/analysis/flow.py``, with its eight rules and their
IDs.  The reference walks a step's jaxpr; the port walks the op trace of one
run of the step (:class:`~repro_torch.analysis.trace.Trace`), node by node
in the order they ran, with taint keyed by tensor identity.  The landmarks
are the same (:mod:`repro_torch.core.tagging`), and so are the rules:

``PF-WIRE-F32``
    A ``wire_payload``-tainted operand of a collective must be int8; in a
    step that uses the wire at all, every all-to-all must carry int8.

``PF-REQUANT``
    A ``decode_out`` value reaching an ``encode_in`` landmark through
    structural ops alone is a dequant -> requant round trip.

``PF-STATS-ROUTE``
    ``wire_stats`` taint must not reach a ``stats_sink`` declared
    ``wire=False``.

``PF-SR-SEED``
    The bits of a stochastic encode (``sr_bits``) must descend from a
    generator of random bits: ``torch.randint``/``rand``/... or the port's
    Philox (:func:`~repro_torch.core.tagging.prng_source`), or be a
    ``Philox``/``GroupPhilox`` stream that a kernel draws in place.

``PF-BUCKET-ENCODE`` / ``PF-BUCKET-DECODE``
    Every (bucket, leaf, rank) tagged ``wire_bucket stage="ready"`` reaches
    exactly one ``encode_in`` landmark (a site is one node of the run); the
    declared bucket count is covered; the buckets the backward's hooks
    handed over (``stage="grad"``) are the ones the wire served; every
    ready bucket has a ``stage="mean"`` landmark that carries
    ``decode_out`` taint.

``PF-GUARD-TAINT``
    In a step that puts payload on the wire, a ``guard_sink`` signal must
    descend from ``wire_stats``.

``PF-KV-WIRE``
    A ``kv_page`` landmark declared ``bits=8`` must be int8.

The reference's structural primitives map to the aten views, reshapes,
copies, casts, concatenations, gathers and selects of
:data:`STRUCTURAL_OPS`; ``wire_payload``, ``decode_out`` and the
``bucket_ready`` labels survive only those, ``wire_stats`` and ``prng``
survive every op.  An op that writes into a tensor replaces that tensor's
taint and adds to the taint of the tensor it is a view of.  A collective
or a kernel launch is not structural.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

from repro_torch.analysis.report import Report

# aten ops that only move or re-type values: taint passes unchanged
STRUCTURAL_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as",
    "transpose", "t", "permute", "expand", "expand_as", "squeeze",
    "unsqueeze", "slice", "select", "narrow", "as_strided", "alias",
    "unfold", "diagonal", "movedim", "flatten", "unflatten", "split",
    "split_with_sizes", "chunk", "unbind", "clone", "contiguous", "copy",
    "copy_", "_to_copy", "to", "detach", "lift_fresh", "cat", "stack",
    "constant_pad_nd", "pad", "flip", "roll", "repeat", "index",
    "index_select", "gather", "take_along_dim", "index_put", "index_put_",
    "slice_scatter", "select_scatter", "where", "masked_select",
    "view_as_real", "view_as_complex",
})

# aten ops that draw random bits
PRNG_OPS = frozenset({
    "randint", "rand", "randn", "random_", "uniform_", "normal_",
    "bernoulli", "bernoulli_", "multinomial", "randperm", "rand_like",
    "randn_like", "randint_like", "exponential_", "geometric_",
})

# the in-kernel generators' sources: a kernel draws the bits in place
PRNG_OBJECTS = frozenset({"Philox", "GroupPhilox"})

_STRUCTURAL_ONLY = frozenset({"wire_payload", "decode_out"})
_BUCKET_READY = "bucket_ready:"
_INT8 = ("s8", "u8")


def _keep_structural(taints: Set[str]) -> Set[str]:
    return {t for t in taints if t not in _STRUCTURAL_ONLY
            and not t.startswith(_BUCKET_READY)}


class _Walker:
    """One taint walk over a trace."""

    def __init__(self, trace, report: Report):
        self.trace = trace
        self.report = report
        self.taints: Dict[int, Set[str]] = {}
        self.uses_wire = False          # any wire_payload landmark
        # bucketed wire: (bucket, leaf, rank) -> encode-site node indices;
        # bucket -> [(where, descends from a decode)]; declared count;
        # buckets the backward's hooks handed over
        self.bucket_sites: Dict[Tuple[int, int, object], Set[int]] = {}
        self.bucket_means: Dict[int, list] = {}
        self.bucket_n = 0
        self.grad_buckets: Set[int] = set()

    def t(self, k: int) -> Set[str]:
        return self.taints.get(k, set())

    def _in(self, node) -> Set[str]:
        out: Set[str] = set()
        for k in node.inputs:
            out |= self.t(k)
        return out

    def walk(self) -> None:
        for node in self.trace.nodes:
            if node.kind == "tag":
                self.tag_node(node)
            elif node.kind == "collective":
                self.collective_node(node)
            else:
                self.compute_node(node)

    def compute_node(self, node) -> None:
        taints = self._in(node)
        if node.kind == "op" and node.name in PRNG_OPS:
            taints.add("prng")
        if node.kind != "op" or node.name not in STRUCTURAL_OPS:
            taints = _keep_structural(taints)
        self._set_outputs(node, taints)

    def _set_outputs(self, node, taints: Set[str]) -> None:
        """A tensor the node made or wrote takes ``taints``; the tensor a
        written view belongs to adds them (its other elements keep
        theirs)."""
        bases = node.meta.get("bases", ())
        for k in node.outputs:
            if k in bases:
                self.taints[k] = self.t(k) | taints
            else:
                self.taints[k] = set(taints)

    def tag_node(self, node) -> None:
        kind, meta, where = node.name, node.meta, node.where
        (k,) = node.inputs
        in_taints = self.t(k)
        out = set(in_taints)
        dom = meta.get("domain")
        info = self.trace.info.get(k)
        dtype = info.dtype if info is not None else None

        if kind == "prng":
            out.add("prng")
        elif kind == "encode_in":
            self.report.mark_checked("PF-REQUANT")
            for t in in_taints:
                if t.startswith(_BUCKET_READY):
                    b, g, r = t[len(_BUCKET_READY):].split(":")
                    self.bucket_sites.setdefault(
                        (int(b), int(g), r), set()).add(node.index)
            if "decode_out" in in_taints:
                self.report.add(
                    "PF-REQUANT",
                    f"decode output re-enters an encode with no intervening "
                    f"compute (domain {dom!r}): a pure dequant→requant "
                    f"round-trip burning wire bytes and rounding noise",
                    where)
        elif kind == "decode_out":
            out.add("decode_out")
        elif kind == "wire_payload":
            self.uses_wire = True
            out.add("wire_payload")
        elif kind == "wire_stats":
            out.add("wire_stats")
        elif kind == "sr_bits":
            self.report.mark_checked("PF-SR-SEED")
            drawn_in_kernel = meta.get("object") in PRNG_OBJECTS
            if "prng" not in in_taints and not drawn_in_kernel:
                self.report.add(
                    "PF-SR-SEED",
                    f"stochastic-rounding bits (domain {dom!r}) do not "
                    f"descend from any generator of random bits — the "
                    f"'stochastic' path is silently deterministic",
                    where)
        elif kind == "wire_bucket":
            stage = meta.get("stage")
            b = int(meta.get("bucket", -1))
            self.bucket_n = max(self.bucket_n, int(meta.get("n", 0)))
            if stage == "ready":
                g, r = int(meta.get("leaf", -1)), meta.get("rank")
                self.bucket_sites.setdefault((b, g, str(r)), set())
                out.add(f"{_BUCKET_READY}{b}:{g}:{r}")
            elif stage == "mean":
                self.bucket_means.setdefault(b, []).append(
                    (where, "decode_out" in in_taints))
            elif stage == "grad":
                self.grad_buckets.add(b)
        elif kind == "kv_page":
            self.report.mark_checked("PF-KV-WIRE")
            bits = int(meta.get("bits", 0) or 0)
            if bits == 8 and dtype is not None and dtype not in _INT8:
                self.report.add(
                    "PF-KV-WIRE",
                    f"paged KV cache {meta.get('stage', '?')} (domain "
                    f"{dom!r}) claims {bits}-bit pages but carries {dtype} "
                    f"— the page pool contract is int8 grid integers",
                    where)
        elif kind == "guard_sink":
            self.report.mark_checked("PF-GUARD-TAINT")
            if self.uses_wire and "wire_stats" not in in_taints:
                self.report.add(
                    "PF-GUARD-TAINT",
                    f"the health-guard signal for domain {dom!r} does not "
                    f"descend from wire-leg statistics — a degradation "
                    f"decision fed by post-fallback (or fabricated) values "
                    f"can never see the storm it exists to detect",
                    where)
        elif kind == "stats_sink":
            self.report.mark_checked("PF-STATS-ROUTE")
            if not meta.get("wire", False) and "wire_stats" in in_taints:
                self.report.add(
                    "PF-STATS-ROUTE",
                    f"wire-leg statistics reach the non-wire controller of "
                    f"domain {dom!r} (stream {meta.get('stream')!r}) — "
                    f"compressed-wire error/overflow would steer a compute "
                    f"format",
                    where)
        self.taints[k] = out

    def collective_node(self, node) -> None:
        self.report.mark_checked("PF-WIRE-F32")
        name = node.name
        for k in node.inputs:
            info = self.trace.info.get(k)
            dtype = info.dtype if info is not None else None
            if dtype is None or dtype in _INT8:
                continue
            tainted = "wire_payload" in self.t(k)
            if tainted or (name == "all-to-all" and self.uses_wire):
                why = ("a wire-payload value" if tainted else
                       "an all-to-all operand in a wire-enabled step")
                self.report.add(
                    "PF-WIRE-F32",
                    f"{why} reaches collective {name!r} as {dtype} — the "
                    f"wire contract is int8 grid integers only",
                    node.where)
        self._set_outputs(node, _keep_structural(self._in(node)))

    def finalize_buckets(self) -> None:
        """PF-BUCKET-ENCODE / PF-BUCKET-DECODE after the walk; vacuous
        when the step has no ``wire_bucket`` landmarks."""
        if not (self.bucket_sites or self.bucket_means or self.grad_buckets):
            return
        self.report.mark_checked("PF-BUCKET-ENCODE", "PF-BUCKET-DECODE")
        ready = {b for b, _, _ in self.bucket_sites}
        for (b, g, r), sites in sorted(self.bucket_sites.items()):
            if not sites:
                self.report.add(
                    "PF-BUCKET-ENCODE",
                    f"bucket {b} leaf {g} (rank {r}) is tagged ready but "
                    f"never reaches a wire encode — the leaf's gradient "
                    f"would be dropped from the synced mean",
                    "<bucket-finalize>")
            elif len(sites) > 1:
                self.report.add(
                    "PF-BUCKET-ENCODE",
                    f"bucket {b} leaf {g} (rank {r}) reaches {len(sites)} "
                    f"distinct wire encodes — a double-encoded payload "
                    f"(wire bytes spent twice; stochastic copies disagree)",
                    f"node{sorted(sites)[0]}")
        if self.bucket_n and ready and ready != set(range(self.bucket_n)):
            missing = sorted(set(range(self.bucket_n)) - ready)
            self.report.add(
                "PF-BUCKET-ENCODE",
                f"the schedule declares {self.bucket_n} buckets but ready "
                f"tags cover only {sorted(ready)} (missing {missing})",
                "<bucket-finalize>")
        if self.grad_buckets and ready and self.grad_buckets != ready:
            self.report.add(
                "PF-BUCKET-ENCODE",
                f"gradient hooks hand over buckets "
                f"{sorted(self.grad_buckets)} but the wire consumes "
                f"{sorted(ready)} — scheduler and collective disagree on "
                f"the plan",
                "<bucket-finalize>")
        for b in sorted(ready):
            if b not in self.bucket_means:
                self.report.add(
                    "PF-BUCKET-DECODE",
                    f"bucket {b} has no decoded-mean tag — the optimizer "
                    f"would consume an unsynced (or undecoded) bucket",
                    "<bucket-finalize>")
        for b, entries in sorted(self.bucket_means.items()):
            if not any(ok for _, ok in entries):
                self.report.add(
                    "PF-BUCKET-DECODE",
                    f"bucket {b}'s mean tag does not descend from a wire "
                    f"decode — raw or re-encoded wire bytes would reach "
                    f"the optimizer",
                    entries[0][0])


def analyze_trace(trace, name: str = "step") -> Report:
    """Run the dataflow pass over a recorded trace; returns a Report."""
    report = Report(name=name)
    report.mark_checked("PF-WIRE-F32", "PF-REQUANT",
                        "PF-STATS-ROUTE", "PF-SR-SEED")
    walker = _Walker(trace, report)
    walker.walk()
    if walker.uses_wire:
        # the all-to-all purity clause of PF-WIRE-F32 applies from the
        # start of the trace once the step is known to use the wire
        second = _Walker(trace, Report(name=name))
        second.uses_wire = True
        second.walk()
        second.finalize_buckets()
        report.violations = second.report.violations
        report.mark_checked(*second.report.checked)
    else:
        walker.finalize_buckets()
    return report

