"""The op trace the three analysis passes read: what one step executed.

The reference's passes read three artifacts of a step that XLA makes before
it runs: the jaxpr, the compiled HLO and the Pallas call sites.  An eager
step has none of them, so the port records what it executes instead.
:class:`Trace` is a ``TorchDispatchMode``: every aten op that runs while it
is open — forward, backward (hooks included), in place or as a view —
becomes one :class:`Node` from its input tensors to its output tensors, by
tensor identity.  An op that writes into a tensor (``copy_``, ``mul_``, an
``out=`` argument) counts it among its outputs, and the tensor it is a view
of as well (listed in the node's ``meta["bases"]``).  The trace holds every
tensor it has seen alive (until :meth:`Trace.release`), so that an identity
is never reused.

Three kinds of node come from the code instead of the dispatcher
(:mod:`repro_torch.core.tagging`): the landmarks (``tag``), one node a
collective, recorded by the transports with the payload's dtype and one
rank's bytes (the ops a stacked transport runs to emulate the move are not
recorded: a stacked all-gather is not an fp32 ``cat``), and one node a
CUDA kernel launch, recorded by its wrapper with its geometry (the
dispatcher cannot see through ``ctypes``; on the CPU the wrappers run their
plain versions, whose ops are recorded as any others).

``Trace(ops=False)`` records the landmarks, collectives and launches only
(the dryrun's count of collective bytes, over hundreds of layers).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tagging

# torch dtype -> the reference's HLO name, so that byte tables compare
HLO_DTYPE = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.uint32: "u32", torch.bool: "pred", torch.complex64: "c64",
}


def hlo_dtype(dtype) -> str:
    try:
        return HLO_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"no HLO name for {dtype} — add it to "
                         "repro_torch.analysis.trace.HLO_DTYPE (a guessed "
                         "byte width would corrupt the accounting)") from None


class TensorInfo(NamedTuple):
    dtype: str               # HLO name
    shape: Tuple[int, ...]
    numel: int
    itemsize: int

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize


class Node:
    """One recorded event.  ``kind``: ``"op"`` (an aten op; ``name`` its
    overload packet, e.g. ``"cat"``), ``"tag"`` (``name`` the landmark's
    kind), ``"collective"`` (``name`` the HLO op) or ``"kernel"`` (``name``
    the ``ctypes`` entry).  ``inputs``/``outputs``: tensor identities
    (``id``) of :attr:`Trace.info`; a landmark's single input is also its
    output, or the id of the non-tensor object it marks."""

    __slots__ = ("index", "kind", "name", "inputs", "outputs", "meta")

    def __init__(self, index, kind, name, inputs, outputs, meta):
        self.index, self.kind, self.name = index, kind, name
        self.inputs, self.outputs, self.meta = inputs, outputs, meta

    @property
    def where(self) -> str:
        return f"node{self.index}:{self.kind}:{self.name}"

    def __repr__(self):
        return (f"Node({self.index}, {self.kind}, {self.name}, "
                f"in={len(self.inputs)}, out={len(self.outputs)})")


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in ``obj`` (a tensor, or lists, tuples and dicts of
    them), in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    out, stack = [], [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            stack.extend(reversed(o))
        elif isinstance(o, dict):
            stack.extend(reversed(list(o.values())))
    return out


def _written_args(func, args, kwargs) -> List[Any]:
    """The arguments an aten op writes into (its schema's ``a!``)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        info = a.alias_info
        if info is None or not info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += _tensors(v)
    return out


class Trace(TorchDispatchMode):
    """Records one run: ``with Trace() as tr: step(...)``; then
    ``tr.nodes`` and ``tr.info``."""

    def __init__(self, ops: bool = True):
        super().__init__()
        self.ops = ops
        self.nodes: List[Node] = []
        self.info: Dict[int, TensorInfo] = {}
        self._alive: List[Any] = []
        self._quiet = 0
        self._saved = None

    # -- the open trace ----------------------------------------------------

    def __enter__(self):
        self._saved, tagging._TRACE[0] = tagging._TRACE[0], self
        if self.ops:
            super().__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.ops:
                super().__exit__(*exc)
        finally:
            tagging._TRACE[0] = self._saved
        return False

    @contextlib.contextmanager
    def quiet(self):
        """Ops run inside are not recorded."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def release(self) -> None:
        """Drop the tensors the trace held (the nodes stay)."""
        self._alive = []

    # -- identities ----------------------------------------------------------

    def _id(self, t) -> int:
        k = id(t)
        if k not in self.info:
            self._alive.append(t)
            if isinstance(t, torch.Tensor):
                self.info[k] = TensorInfo(hlo_dtype(t.dtype), tuple(t.shape),
                                          t.numel(), t.element_size())
            else:
                self.info[k] = TensorInfo(type(t).__name__, (), 0, 0)
        return k

    def _ids(self, objs) -> Tuple[int, ...]:
        out, seen = [], set()
        for t in _tensors(objs):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(self._id(t))
        return tuple(out)

    def _bases(self, written) -> Tuple[int, ...]:
        """The tensors the written views are views of."""
        return tuple(self._id(t._base) for t in written
                     if t._base is not None)

    def _add(self, kind, name, inputs, outputs, meta) -> Node:
        node = Node(len(self.nodes), kind, name, inputs, outputs, meta)
        self.nodes.append(node)
        return node

    # -- what the dispatcher sees ---------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        written = _written_args(func, args, kwargs)
        bases = self._bases(written)
        outs = self._ids(out) + self._ids(written) + bases
        self._add("op", func.overloadpacket.__name__,
                  self._ids((args, kwargs)), tuple(dict.fromkeys(outs)),
                  {"bases": bases} if bases else {})
        return out

    # -- what the code declares (repro_torch.core.tagging) --------------------

    def landmark(self, x, kind: str, meta: dict) -> None:
        k = self._id(x)
        m = dict(meta)
        if not isinstance(x, torch.Tensor):
            m["object"] = type(x).__name__
        self._add("tag", kind, (k,), (k,), m)

    def collective(self, op: str, inputs, fn, *, nbytes: int, dtype):
        self._quiet += 1
        try:
            result = fn()
        finally:
            self._quiet -= 1
        self._add("collective", op, self._ids(inputs), self._ids(result),
                  {"nbytes": nbytes, "dtype": hlo_dtype(dtype)})
        return result

    def launch(self, kernel: str, inputs, outputs, geometry: dict) -> None:
        written = _tensors(outputs)
        bases = self._bases(written)
        self._add("kernel", kernel, self._ids(inputs),
                  tuple(dict.fromkeys(self._ids(written) + bases)),
                  dict(geometry, bases=bases))

    # -- reading --------------------------------------------------------------

    def of_kind(self, kind: str, name: Optional[str] = None) -> List[Node]:
        return [n for n in self.nodes
                if n.kind == kind and (name is None or n.name == name)]
