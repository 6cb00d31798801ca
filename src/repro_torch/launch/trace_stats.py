"""Collective and op accounting of a recorded step, for the lint, the
dryrun and the tests.

Counterpart of ``repro/launch/hlo_stats.py``, which parses optimized HLO;
here the same numbers are read off a :class:`~repro_torch.analysis.trace.
Trace`.  The transports record one node a collective with the payload's
dtype and ONE rank's bytes — the per-device convention of the reference's
SPMD HLO: an all-to-all's whole per-rank buffer, an all-gather's gathered
result, an all-reduce's operand, a reduce-scatter's full input — so the two
packages' tables compare entry for entry:

* :func:`collective_wire_bytes` — ring-model wire bytes per (op, dtype): an
  all-reduce moves ~2× its payload (reduce-scatter + all-gather phases),
  the other collectives ~1×;
* :func:`op_bytes` / :func:`concat_bytes` — result bytes of an aten op by
  dtype (the zero-fp32-concat probe of the tree wire);
* :func:`wire_bytes_summary` — int8 against fp32;
* :func:`largest_tensors` — the largest tensor of each dtype the step
  touched (the paged-KV rules' size scale).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

# interconnect traversals per payload byte under the ring model
RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def _collectives(trace) -> Iterator[Tuple[str, str, float]]:
    """``(op, dtype, payload_bytes)`` per recorded collective."""
    for node in trace.of_kind("collective"):
        if node.name not in RING_FACTOR:
            raise ValueError(f"unknown collective {node.name!r} at "
                             f"{node.where}")
        yield node.name, node.meta["dtype"], float(node.meta["nbytes"])


def collective_wire_bytes(trace) -> Dict[str, object]:
    """``{"by_op_dtype": {op: {dtype: bytes}}, "by_dtype": {dtype: bytes},
    "total": float}``: every collective contributes ``RING_FACTOR[op] ×``
    its payload under its payload dtype."""
    by_op: Dict[str, Dict[str, float]] = {}
    by_dtype: Dict[str, float] = {}
    total = 0.0
    for op, dtype, nbytes in _collectives(trace):
        wire = RING_FACTOR[op] * nbytes
        by_op.setdefault(op, {})
        by_op[op][dtype] = by_op[op].get(dtype, 0.0) + wire
        by_dtype[dtype] = by_dtype.get(dtype, 0.0) + wire
        total += wire
    return {"by_op_dtype": by_op, "by_dtype": by_dtype, "total": total}


def op_bytes(trace, op_name: str) -> Dict[str, object]:
    """Result bytes of every ``op_name`` aten op (``"cat"``, ``"mm"``, ...),
    split by dtype: ``{"by_dtype", "total", "count"}``."""
    by_dtype: Dict[str, float] = {}
    count = 0
    for node in trace.of_kind("op", op_name):
        if not node.outputs:
            continue
        info = trace.info[node.outputs[0]]
        by_dtype[info.dtype] = by_dtype.get(info.dtype, 0.0) + info.nbytes
        count += 1
    return {"by_dtype": by_dtype,
            "total": float(sum(by_dtype.values())), "count": count}


def concat_bytes(trace) -> Dict[str, object]:
    """:func:`op_bytes` of ``cat`` — the fp32 flat-concat probe."""
    return op_bytes(trace, "cat")


def wire_bytes_summary(trace) -> Dict[str, float]:
    """Ring-model wire bytes on the int8 payload against fp32, and the
    int8 fraction of the total."""
    w = collective_wire_bytes(trace)
    int8 = w["by_dtype"].get("s8", 0.0) + w["by_dtype"].get("u8", 0.0)
    fp32 = w["by_dtype"].get("f32", 0.0)
    total = w["total"]
    return {"total": total, "int8": int8, "fp32": fp32,
            "int8_fraction": (int8 / total) if total else 0.0}


def largest_tensors(trace) -> Dict[str, int]:
    """dtype -> the element count of the largest tensor of that dtype any
    recorded node read or wrote (the step's inputs included)."""
    out: Dict[str, int] = {}
    for info in trace.info.values():
        if info.itemsize:
            out[info.dtype] = max(out.get(info.dtype, 0), info.numel)
    return out
