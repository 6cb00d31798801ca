"""Landmarks for the precision-flow verifier, and the hooks of its recorder.

Counterpart of ``repro/core/tagging.py``.  The reference's ``dps_tag`` is
an identity primitive that survives into the jaxpr, where
``repro.analysis.flow`` reads its parameters.  Eager PyTorch has no jaxpr:
:func:`tag` returns ``x`` itself — no copy, no launch, no custom op — and,
while a :class:`repro_torch.analysis.trace.Trace` is open, records the
landmark in that trace: its kind, domain and metadata, and the identity,
dtype and shape of the tensor.  With no trace open a tag costs one Python
branch.  The kinds are the reference's:

    kind="encode_in"     the fp32 value about to be wire-quantized
    kind="decode_out"    the fp32 value a wire decode just produced
    kind="wire_payload"  the int8 buffer about to enter a collective
    kind="wire_stats"    QuantStats fields a wire leg measured
    kind="sr_bits"       the bits of a stochastic encode: a tensor of them,
                         or the :class:`~repro_torch.kernels.dps_quant.
                         Philox`/``GroupPhilox`` stream a kernel draws them
                         from
    kind="stats_sink"    a stream a controller is about to consume
    kind="guard_sink"    a health guard's degradation signal
    kind="kv_page"       a paged-KV pool write or read (``bits=8``: int8)
    kind="wire_bucket"   a bucketed-wire landmark (repro_torch.dist.overlap):
                         stage="grad" where the backward hands a leaf's
                         gradient over, stage="ready" on the leaf handed to
                         the wire, stage="mean" on the decoded bucket mean —
                         with bucket=b, n=<bucket count>, leaf=g and the
                         rank for per-leaf stages

and one of the port's own: ``kind="prng"`` on the output of a generator of
random bits (:func:`prng_source`), the counterpart of the reference's
threefry primitives.

The recorder's other hooks live here too, so that the modules they
instrument import nothing of the analysis package: :func:`collective` (a
transport's collective, one node a call) and :func:`launch` (a CUDA kernel
wrapper's launch, which the dispatcher cannot see through ``ctypes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Iterator, Optional

import torch

# the open trace (repro_torch.analysis.trace.Trace), or None
_TRACE = [None]


def active():
    """The open trace, or None."""
    return _TRACE[0]


# ---------------------------------------------------------------------------
# Ambient domain context: collectives enter ``with tagging.domain(name)``
# so every tag below them resolves its precision domain without threading
# the name through each helper.
# ---------------------------------------------------------------------------

_DOMAIN_STACK: list = []


@contextlib.contextmanager
def domain(name: str) -> Iterator[None]:
    """Tags made inside resolve ``domain=name``."""
    _DOMAIN_STACK.append(name)
    try:
        yield
    finally:
        _DOMAIN_STACK.pop()


def current_domain() -> Optional[str]:
    return _DOMAIN_STACK[-1] if _DOMAIN_STACK else None


def tag(x, kind: str, **meta):
    """Mark ``x`` with ``kind`` for the precision-flow analyzer; returns
    ``x`` itself.  ``domain`` defaults to the ambient :func:`domain`
    context; the metadata is stored as it is given."""
    tr = _TRACE[0]
    if tr is None:
        return x
    meta.setdefault("domain", current_domain())
    tr.landmark(x, kind, meta)
    return x


def tensor_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses
    (``QuantStats``), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensor_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def tag_tree(tree, kind: str, **meta):
    """:func:`tag` every tensor of ``tree``; returns ``tree`` itself."""
    if _TRACE[0] is None:
        return tree
    for leaf in tensor_leaves(tree):
        tag(leaf, kind, **meta)
    return tree


def tag_params(node) -> Optional[dict]:
    """A trace node's tag parameters ``{"kind": ..., **meta}``, or None if
    the node is not a landmark."""
    if getattr(node, "kind", None) != "tag":
        return None
    out = {"kind": node.name}
    out.update(node.meta)
    return out


def prng_source(fn):
    """Decorate a function that makes random bits: under a trace its own
    ops are not recorded (its output is a PRNG origin, whatever arithmetic
    made it), and its tensor output is tagged ``kind="prng"``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        tr = _TRACE[0]
        if tr is None:
            return fn(*args, **kwargs)
        with tr.quiet():
            out = fn(*args, **kwargs)
        return tag(out, "prng")
    return wrapped


def collective(op: str, inputs, fn, *, nbytes: int, dtype):
    """Run ``fn()`` — a transport's collective ``op`` (the reference's HLO
    names: ``"all-to-all"``, ``"all-gather"``, ``"all-reduce"``,
    ``"reduce-scatter"``) on ``inputs`` — and return what it returns.  With
    a trace open, the call is one node: ``nbytes`` is one rank's payload
    (the per-device convention of the reference's HLO), ``dtype`` the
    payload's; the ops ``fn`` runs to emulate the move are not recorded."""
    tr = _TRACE[0]
    if tr is None:
        return fn()
    return tr.collective(op, inputs, fn, nbytes=int(nbytes), dtype=dtype)


def launch(geometry, inputs, outputs, **meta: Any) -> None:
    """Record one launch of a CUDA kernel with its operands, results and
    geometry — ``geometry()``, a ``KernelCallGeometry`` whose ``kernel``
    names the ``ctypes`` entry, built only while a trace is open — and
    ``meta`` beside it (the call's ``args``)."""
    tr = _TRACE[0]
    if tr is not None:
        geom = geometry()
        fields = {f.name: getattr(geom, f.name)
                  for f in dataclasses.fields(geom)}
        tr.launch(fields.pop("kernel"), inputs, outputs, {**fields, **meta})
