"""Logical-axis placement rules, the mesh context, and the ZeRO-1 flat
layouts.

Counterpart of ``repro/dist/sharding.py``, both halves.

**Placement.**  Model code never names mesh axes.  It names *logical* axes
("batch", "tp", "fsdp", "expert", ...) and :class:`LogicalRules` resolves
them against the mesh a run built, with the **divisibility fallback**: a
logical axis binds a mesh axis only when the mesh-axis size divides the
tensor dimension; otherwise the dimension stays replicated, and a mesh axis
never shards two dimensions of one tensor.  A *spec* is a tuple with one
entry per dimension (``None``, a mesh axis, or a tuple of mesh axes that
shard the dimension jointly, first axis major): the counterpart of a
``PartitionSpec``, and equal to the reference's entry for entry.

:func:`axis_rules` binds a mesh and the rules for the code it wraps:

    with axis_rules(make_mesh((1, 4), ("data", "model")), LogicalRules()):
        ...

Three kinds of mesh are read (:func:`_axis_sizes`): the reference's duck
type (``axis_names``, ``devices.shape``), the port's :class:`StackedMesh`
(every rank in this process on one device, each axis a
:class:`~repro_torch.dist.transport.StackedTransport`) and a
``torch.distributed`` ``DeviceMesh`` of processes.

**Placed tensors** (:class:`Placed`): where the reference's GSPMD decides
where values live, the port's placed step says it: a ``Placed`` holds the
blocks of the ranks this process holds, with the tensor's spec, and
:func:`place` / :func:`gather_placed` cut a tree into blocks and stitch it
back.  :func:`logical_constraint` on a ``Placed`` is a real re-layout
(:func:`relayout`: pending sums reduce-scattered or summed, dimensions
gathered and sliced over the named axes); on a whole tensor it is, as
under GSPMD, the identity.  The collectives (:func:`all_gather`,
:func:`reduce_scatter`, :func:`psum`, :func:`psum_backward`, :func:`pmax`)
run over one axis's groups through its transport, each with its exact
transpose, so one program serves a :class:`StackedMesh` and a
``DeviceMesh`` alike.  The MoE layer's expert-parallel dispatch on whole
activations cuts each rank's block with :func:`local_block` and stitches
the results with :func:`stitch_blocks`.

**ZeRO-1 flat layouts** (``ZeroPartitioner``, ``GroupAlignedPartitioner``).
A partitioner lays a tree out as one fp32 vector of ``padded_size``
elements and cuts it into ``n_shards`` shards of ``shard_size``: rank ``r``
steps the optimizer on shard ``r`` only.  The layout is the contract
between the ZeRO pieces: the compressed reduce-scatter hands each owner
its shard of the gradient mean, the optimizer steps that slice
(``SGD.update_shard`` / ``AdamW.update_shard``), and the all-gather of the
updated shards rebuilds the flat vector.  Padding is zero and stays zero
(zero gradient and zero parameter give a zero update).

Where the reference flattens the tree every step, the port keeps the
parameters IN the flat vector: :meth:`flat_view` copies a tree into a new
flat buffer once and returns a tree whose leaves are views into it, so the
optimizer's in-place update of a shard is the parameters' update, and a
3.2 B-parameter model needs no second fp32 copy (12.85 GB) beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.dist.collectives import (GroupLayout, default_wire_quantum,
                                          group_layout)
from repro_torch.dist.transport import ProcessGroupTransport, StackedTransport

# One candidate assignment: a single mesh axis or a tuple of mesh axes that
# shard a dimension jointly (e.g. batch over ("pod", "data")).
Axis = Union[str, Tuple[str, ...]]

# Logical axis -> mesh-axis candidates, tried in order.  The first candidate
# whose axes (a) all exist in the mesh, (b) are not already taken by another
# dimension of the same tensor, and (c) whose combined size divides the
# tensor dimension, wins.  Logical names absent from this table ("embed",
# "seq", "kv_seq", "head_dim", "layers", ...) always replicate.
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Axis, ...]], ...] = (
    ("batch", (("pod", "data"), "data")),
    ("batch2d", (("pod", "data", "model"), ("data", "model"))),
    ("fsdp", (("pod", "data"), "data")),
    ("tp", ("model",)),
    ("tp_seq", ("model",)),
    ("heads", ("model",)),
    ("kv", ("model",)),
    ("expert", ("model",)),
    ("vocab_out", ("model",)),
)


class StackedMesh:
    """A mesh whose every rank this process holds, on one device.

    The counterpart of a ``jax.sharding.Mesh`` for one card: each rank's
    work runs with the shapes and bytes it has on a real mesh, and each axis
    is a :class:`~repro_torch.dist.transport.StackedTransport`, whose copy
    between ranks is a view or a permute of the stacked rank blocks."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.device = device
        self._transports = {a: StackedTransport(n, device)
                            for a, n in zip(self.axis_names, self.shape)}
        self.coords = tuple(itertools.product(*(range(n) for n in self.shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def transport(self, axis: str) -> StackedTransport:
        return self._transports[axis]

    def __repr__(self):
        return f"StackedMesh({dict(zip(self.axis_names, self.shape))})"


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def _axis_sizes(mesh) -> dict:
    """Axis name -> size: a ``DeviceMesh`` (``mesh_dim_names``, ``size``),
    a :class:`StackedMesh`, or the reference's duck type (``axis_names``,
    ``devices.shape``; its sharding-rules tests build one with only
    those)."""
    if _is_device_mesh(mesh):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    if isinstance(mesh, StackedMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def held_coords(mesh) -> Sequence[Tuple[int, ...]]:
    """The mesh coordinates of the ranks this process holds, row-major:
    every one of a :class:`StackedMesh`, this process's own of a
    ``DeviceMesh``."""
    if _is_device_mesh(mesh):
        return [tuple(mesh.get_coordinate())]
    return mesh.coords


def axis_transport(mesh, axis: str):
    """The transport of one mesh axis: the mesh's own (a stacked mesh's,
    or the one-rank view of ``repro_torch.launch.dryrun``), or a
    :class:`~repro_torch.dist.transport.ProcessGroupTransport` over the
    ``DeviceMesh``'s process group of that axis."""
    if hasattr(mesh, "transport"):
        return mesh.transport(axis)
    return ProcessGroupTransport(mesh.get_group(axis))


def mesh_mean(mesh, rows: torch.Tensor) -> torch.Tensor:
    """The mean over every rank of the mesh of ``rows`` ``[held, ...]``
    (one row per rank this process holds, in :func:`held_coords` order),
    summed one axis at a time from the last, in rank order on each, by
    every kind of mesh alike.  Autograd passes through."""
    names = tuple(_axis_sizes(mesh))
    sizes = _axis_sizes(mesh)
    if _is_device_mesh(mesh):
        t = rows[0]
        for a in reversed(names):
            if sizes[a] > 1:
                t = axis_transport(mesh, a).gather_rows(t).sum(0)
    else:
        t = rows.reshape(*(sizes[a] for a in names), *rows.shape[1:])
        for k in reversed(range(len(names))):
            t = t.sum(k)
    return t / math.prod(sizes.values())


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Logical-axis resolution table with the divisibility fallback."""

    rules: Tuple[Tuple[str, Tuple[Axis, ...]], ...] = DEFAULT_RULES

    def candidates(self, logical: str) -> Tuple[Axis, ...]:
        for name, cands in self.rules:
            if name == logical:
                return cands
        return ()

    def _resolve(self, logical: Optional[str], dim: int, sizes: dict,
                 taken: set) -> Optional[Axis]:
        if logical is None:
            return None
        for cand in self.candidates(logical):
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a not in sizes or a in taken for a in axes):
                continue
            n = math.prod(sizes[a] for a in axes)
            if n <= 1 or dim % n:
                continue
            taken.update(axes)
            return cand
        return None

    def resolve_dim(self, logical: Optional[str], dim: int, mesh,
                    taken: set) -> Optional[Axis]:
        """Resolve one tensor dimension to a mesh axis (or ``None``).
        ``taken`` is updated: axes consumed here are unavailable to the
        remaining dimensions of the same tensor."""
        return self._resolve(logical, dim, _axis_sizes(mesh), taken)

    def spec(self, logical: Sequence[Optional[str]], shape: Sequence[int],
             mesh) -> Tuple[Optional[Axis], ...]:
        """The spec of a whole tensor (one ``taken`` set for its dims)."""
        assert len(logical) == len(shape), (tuple(logical), tuple(shape))
        sizes, taken = _axis_sizes(mesh), set()
        return tuple(self._resolve(name, dim, sizes, taken)
                     for name, dim in zip(logical, shape))


def _is_axes_leaf(x) -> bool:
    """A logical-axes annotation: None or a tuple of str/None entries."""
    return x is None or (isinstance(x, tuple)
                         and all(e is None or isinstance(e, str) for e in x))


def tree_specs(logical, struct, mesh, rules: LogicalRules):
    """Resolve a tree of logical-axes tuples against ``struct``'s shapes.

    ``logical`` mirrors ``struct`` (dicts, tuples, lists) with each tensor
    replaced by its logical-axes tuple (``models.common.logical_tree``,
    a family's ``cache_logical``).  Returns the same tree of specs."""
    if _is_axes_leaf(logical):
        return rules.spec(logical, struct.shape, mesh)
    if isinstance(logical, dict):
        return {k: tree_specs(logical[k], struct[k], mesh, rules)
                for k in logical}
    return type(logical)(tree_specs(l, s, mesh, rules)
                         for l, s in zip(logical, struct))


def _block_index(spec, sizes: dict, at: dict, shape) -> Tuple[slice, ...]:
    idx = []
    for d, entry in enumerate(spec):
        if entry is None:
            idx.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        i = 0
        for a in axes:
            i = i * sizes[a] + at[a]
        blk = shape[d] // math.prod(sizes[a] for a in axes)
        idx.append(slice(i * blk, (i + 1) * blk))
    return tuple(idx)


def local_block(x: torch.Tensor, spec, mesh, coord: Sequence[int]
                ) -> torch.Tensor:
    """The block of ``x`` (a view) that the rank at mesh coordinate
    ``coord`` (one index per mesh axis) holds under ``spec``."""
    return local_blocks(x, spec, mesh, [coord])[0]


def local_blocks(x: torch.Tensor, spec, mesh, coords
                 ) -> List[torch.Tensor]:
    """The blocks (views) that the ranks at ``coords`` hold, cut by one
    ``chunk`` a sharded dimension: the backward writes the blocks'
    gradients into one buffer, where a slice a block would write a
    full-size zero gradient per block.  Ranks that hold the same
    (replicated) block share one tensor."""
    sizes = _axis_sizes(mesh)
    pieces = {(): x}
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            n = math.prod(sizes[a] for a in axes)
            pieces = {k + (i,): p for k, t in pieces.items()
                      for i, p in enumerate(t.chunk(n, dim=d))}
    out = []
    for coord in coords:
        at, key = dict(zip(sizes, coord)), ()
        for entry in spec:
            if entry is not None:
                i = 0
                for a in ((entry,) if isinstance(entry, str) else entry):
                    i = i * sizes[a] + at[a]
                key += (i,)
        out.append(pieces[key])
    return out


def stitch_blocks(blocks: Sequence[torch.Tensor], spec, mesh,
                  coords: Sequence[Sequence[int]], shape) -> torch.Tensor:
    """The whole tensor of ``shape`` from the ``blocks`` that the ranks at
    ``coords`` hold under ``spec``: the inverse of :func:`local_block`
    over every rank.  Where ranks hold the same (replicated) block, the
    first one's is taken.  Autograd passes through."""
    sizes = _axis_sizes(mesh)
    out = blocks[0].new_empty(tuple(shape))
    done = set()
    for blk, coord in zip(blocks, coords):
        idx = _block_index(spec, sizes, dict(zip(sizes, coord)), shape)
        key = tuple((s.start, s.stop) for s in idx)
        if key not in done:
            done.add(key)
            out[idx] = blk
    return out


# ---------------------------------------------------------------------------
# Placed tensors: a tensor held rank by rank.
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits a dimension over."""
    return tuple(a for e in spec for a in _entry_axes(e))


def block_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of each rank's block of a tensor of ``shape`` under
    ``spec`` (every dimension divides: the rules' fallback sees to it)."""
    sizes = _axis_sizes(mesh)
    out = []
    for d, e in zip(shape, spec):
        n = math.prod(sizes[a] for a in _entry_axes(e))
        if d % n:
            raise ValueError(f"dimension {d} does not split {n} ways "
                             f"(spec {tuple(spec)})")
        out.append(d // n)
    return tuple(out)


def block_origin(shape, spec, mesh, coord) -> Tuple[int, ...]:
    """The index in the whole tensor of the first element of the block
    the rank at mesh coordinate ``coord`` holds."""
    sizes = _axis_sizes(mesh)
    return tuple(s.start or 0 for s in _block_index(
        spec, sizes, dict(zip(sizes, coord)), shape))


def axis_index(mesh, coord, axes) -> int:
    """The rank's index along the joint axes ``axes`` (first major)."""
    sizes = _axis_sizes(mesh)
    at = dict(zip(sizes, coord))
    i = 0
    for a in axes:
        i = i * sizes[a] + at[a]
    return i


def axis_groups(mesh, axis: str) -> List[List[int]]:
    """The held ranks (indices into :func:`held_coords`) grouped by their
    coordinates on every axis but ``axis``, each group in ``axis`` order:
    the groups a collective over ``axis`` runs in."""
    if _is_device_mesh(mesh):
        return [[0]]
    at = list(_axis_sizes(mesh)).index(axis)
    coords = held_coords(mesh)
    groups = {}
    for i, c in enumerate(coords):
        groups.setdefault(c[:at] + c[at + 1:], []).append(i)
    return [sorted(g, key=lambda i: coords[i][at]) for g in groups.values()]


def _over_axis(mesh, axis: str, blocks, op):
    """``op(transport, group blocks) -> group blocks`` in every group of
    ``axis``; a stacked axis of one rank is the identity (a process
    group's runs its collective, of one rank)."""
    if _axis_sizes(mesh)[axis] == 1 and not _is_device_mesh(mesh):
        return list(blocks)
    t = axis_transport(mesh, axis)
    out = [None] * len(blocks)
    for g in axis_groups(mesh, axis):
        for i, y in zip(g, op(t, [blocks[i] for i in g])):
            out[i] = y
    return out


def all_gather(mesh, axis: str, blocks, dim: int):
    """Blocks concatenated along ``dim`` over ``axis`` (backward:
    reduce-scatter)."""
    return _over_axis(mesh, axis, blocks,
                      lambda t, xs: t.gather_blocks(xs, dim))


def reduce_scatter(mesh, axis: str, blocks, dim: int):
    """The sum over ``axis``, each rank its chunk along ``dim``
    (backward: all-gather)."""
    return _over_axis(mesh, axis, blocks,
                      lambda t, xs: t.reduce_scatter_blocks(xs, dim))


def psum(mesh, axes, blocks, grad: str = "psum"):
    """The sum over each of ``axes`` in turn, in rank order (backward: the
    sum again, or with ``grad="identity"`` each rank's own)."""
    for a in axes:
        blocks = _over_axis(mesh, a, blocks,
                            lambda t, xs: t.psum_blocks(xs, grad))
    return blocks


def psum_backward(mesh, axes, blocks):
    """The identity forward; backward, every rank's gradient summed over
    each of ``axes`` (Megatron's ``f``)."""
    for a in axes:
        blocks = _over_axis(mesh, a, blocks, lambda t, xs: t.copy_blocks(xs))
    return blocks


def pmax(mesh, axes, blocks):
    """The elementwise max over each of ``axes``, outside autograd."""
    for a in axes:
        blocks = _over_axis(mesh, a, blocks, lambda t, xs: t.pmax_blocks(xs))
    return blocks


class Placed:
    """A tensor of ``shape`` held rank by rank under ``spec`` on ``mesh``:
    ``blocks[i]`` is the block of the rank at ``held_coords(mesh)[i]``
    (on a :class:`StackedMesh` every rank's, ranks that hold the same
    block sharing one tensor; on a ``DeviceMesh`` this process's own).
    ``partial``: mesh axes over which the blocks are addends still to be
    summed (a row-parallel product's output) — :func:`relayout` sums them.

    The counterpart of a ``jax.Array`` under a ``NamedSharding``, with the
    placement explicit: model code under a placed step computes on
    ``blocks`` rank by rank and moves data between ranks only through
    :func:`relayout` (:func:`logical_constraint`) and the collectives
    above."""

    __slots__ = ("blocks", "spec", "mesh", "shape", "partial")

    def __init__(self, blocks, spec, mesh, shape=None, partial=()):
        self.blocks = list(blocks)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.partial = tuple(partial)
        if shape is None:
            sizes = _axis_sizes(mesh)
            shape = tuple(d * math.prod(sizes[a] for a in _entry_axes(e))
                          for d, e in zip(self.blocks[0].shape, self.spec))
        self.shape = tuple(shape)
        if len(self.spec) != len(self.shape):
            raise ValueError(f"spec {self.spec} does not match shape "
                             f"{self.shape}")

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return (f"Placed(shape={self.shape}, spec={self.spec}, "
                f"partial={self.partial}, {len(self.blocks)} blocks)")

    def _apply(self, fn, others):
        per = [o.blocks if isinstance(o, Placed) else None for o in others]
        memo, out = {}, []
        for i, b in enumerate(self.blocks):
            args = [p[i] if p is not None else o for p, o in zip(per, others)]
            key = (id(b),) + tuple(id(a) for a, p in zip(args, per)
                                   if p is not None)
            if key not in memo:
                memo[key] = fn(b, *args)
            out.append(memo[key])
        return out

    def map(self, fn, *others, spec=None, partial=None) -> "Placed":
        """``fn(block, *others' blocks)`` rank by rank (an ``other`` that
        is not Placed is passed to every rank as it is); the result laid
        out by ``spec`` (this one's by default), its global shape read
        from the blocks.  Ranks whose inputs are the same tensors (a
        stacked mesh's shared blocks) share one result."""
        return Placed(self._apply(fn, others),
                      self.spec if spec is None else spec, self.mesh,
                      partial=self.partial if partial is None else partial)

    def map_many(self, fn, *others, specs) -> Tuple["Placed", ...]:
        """:meth:`map` for an ``fn`` that returns a tuple: one placed
        result for each entry, laid out by ``specs``."""
        out = self._apply(fn, others)
        return tuple(Placed([r[j] for r in out], s, self.mesh)
                     for j, s in enumerate(specs))

    def to(self, *args, **kwargs) -> "Placed":
        """Every block's ``Tensor.to``."""
        return self.map(lambda b: b.to(*args, **kwargs))

    def __add__(self, other) -> "Placed":
        """The elementwise sum rank by rank, a placed ``other`` laid out
        like this tensor first (so model code adds two placed tensors as
        it adds two whole ones)."""
        if self.partial:
            raise ValueError("a partial sum takes no addend before it is "
                             "summed")
        if isinstance(other, Placed) and (other.spec != self.spec
                                          or other.partial):
            other = relayout(other, self.spec)
        return self.map(torch.add, other)

    def distinct(self):
        """``(index, block)`` of each distinct block tensor, first holder
        first (a stacked mesh's replicated ranks share one)."""
        seen, out = set(), []
        for i, b in enumerate(self.blocks):
            if id(b) not in seen:
                seen.add(id(b))
                out.append((i, b))
        return out

    def geometry(self, i: int):
        """``(origin, block shape)`` of held rank ``i``'s block in the
        whole tensor."""
        coord = held_coords(self.mesh)[i]
        return (block_origin(self.shape, self.spec, self.mesh, coord),
                tuple(self.blocks[i].shape))

    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes (size > 1) this tensor is NOT split over."""
        used = set(spec_axes(self.spec))
        return tuple(a for a, n in _axis_sizes(self.mesh).items()
                     if n > 1 and a not in used)


def is_placed(x) -> bool:
    return isinstance(x, Placed)


def place_tensor(x: torch.Tensor, spec, mesh) -> Placed:
    """``x`` cut into the blocks the held ranks hold under ``spec``, each
    a contiguous copy (one copy per distinct block)."""
    coords = held_coords(mesh)
    views = local_blocks(x, spec, mesh, coords)
    memo, blocks = {}, []
    for v in views:
        if id(v) not in memo:
            memo[id(v)] = v.detach().contiguous().clone()
        blocks.append(memo[id(v)])
    return Placed(blocks, spec, mesh, tuple(x.shape))


def place(tree, specs, mesh):
    """A tree (dicts, tuples) of tensors placed leaf by leaf under the
    same tree of ``specs`` (e.g.
    :func:`repro_torch.launch.specs.param_shardings`, a decode cache's
    specs): each leaf a :class:`Placed` of the blocks this process
    holds."""
    if isinstance(tree, torch.Tensor):
        return place_tensor(tree, specs, mesh)
    if hasattr(tree, "items"):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(place(v, s, mesh) for v, s in zip(tree, specs))
    raise TypeError(f"cannot place a {type(tree).__name__}")


def place_zeros(struct, specs, mesh, device):
    """Zero :class:`Placed` leaves on ``device`` for a tree (dicts,
    tuples) of stand-ins (``shape``, ``dtype``; a family's
    ``cache_struct``) under a tree of specs: each held rank's block, one
    allocation for each distinct block (a stacked mesh's ranks that hold
    the same block share it), nothing whole."""
    if hasattr(struct, "items"):
        return {k: place_zeros(v, specs[k], mesh, device)
                for k, v in struct.items()}
    if isinstance(struct, tuple):
        return tuple(place_zeros(v, s, mesh, device)
                     for v, s in zip(struct, specs))
    shape = block_shape(struct.shape, specs, mesh)
    memo, blocks = {}, []
    for c in held_coords(mesh):
        at = block_origin(struct.shape, specs, mesh, c)
        if at not in memo:
            memo[at] = torch.zeros(shape, dtype=struct.dtype, device=device)
        blocks.append(memo[at])
    return Placed(blocks, specs, mesh, tuple(struct.shape))


def unbind_placed(p: Placed, dim: int = 0) -> List[Placed]:
    """A placed tensor unbound along an unsplit ``dim`` (a stack's layers):
    one placed view for each index, each distinct block unbound once."""
    if p.spec[dim] is not None:
        raise ValueError(f"dimension {dim} is split ({p.spec})")
    parts = {id(b): torch.unbind(b, dim) for _, b in p.distinct()}
    cut = lambda t: t[:dim] + t[dim + 1:]
    return [Placed([parts[id(b)][i] for b in p.blocks], cut(p.spec), p.mesh,
                   cut(p.shape)) for i in range(p.shape[dim])]


def write_rows(dst: Placed, new: Placed, pos: Placed) -> None:
    """In place: row ``b`` of ``new`` (B, ...) written into ``dst`` (B, S,
    ...) at position ``pos[b]`` — a decode step's token into its cache.
    ``new`` is laid out like ``dst`` without its S dim (moved there
    first), ``pos`` (B,) like its batch; each distinct block of ``dst`` is
    written once, by the first rank that holds it, from that rank's rows
    (``new`` cast to ``dst``'s dtype).  ``dst``'s S dim is unsplit."""
    if dst.spec[1] is not None:
        raise ValueError(f"the written dimension is split ({dst.spec})")
    new = relayout(new, dst.spec[:1] + dst.spec[2:])
    pos = relayout(pos, dst.spec[:1])
    with torch.no_grad():
        for i, d in dst.distinct():
            rows = torch.arange(d.shape[0], device=d.device)
            d[rows, pos.blocks[i].to(torch.int64)] = new.blocks[i].to(d.dtype)


def write_prefix(dst: Placed, new: Placed) -> None:
    """In place: ``new`` (B, S, ...) written into the first S positions of
    ``dst`` (B, S_max, ...) — a prompt's keys into a cache of ``S_max`` —
    ``new`` laid out like ``dst`` first, each distinct block once."""
    new = relayout(new, dst.spec)
    with torch.no_grad():
        for i, d in dst.distinct():
            d[:, :new.shape[1]] = new.blocks[i].to(d.dtype)


def placed_argmax(x: Placed) -> Placed:
    """The index of the largest entry along ``x``'s last dim, which may be
    split (logits over ``vocab_out`` blocks), ties to the lowest index as
    ``jnp.argmax`` breaks them: each rank's first largest entry in its
    block, then, over the split in block order, the first block whose
    largest is the largest.  int64, laid out like ``x`` without its last
    dim."""
    axes, last = _entry_axes(x.spec[-1]), x.ndim - 1
    vals, idx = [], []
    for i, b in enumerate(x.blocks):
        # torch.argmax gives the first largest entry's index
        vals.append(b.amax(dim=-1, keepdim=True))
        idx.append(b.argmax(dim=-1, keepdim=True) + x.geometry(i)[0][-1])
    with torch.no_grad():
        for a in reversed(axes):
            vals = all_gather(x.mesh, a, vals, last)
            idx = all_gather(x.mesh, a, idx, last)
    out = [torch.gather(j, -1, v.argmax(dim=-1, keepdim=True))[..., 0]
           for v, j in zip(vals, idx)]
    return Placed(out, x.spec[:-1], x.mesh, x.shape[:-1])


def _gather_whole(p: Placed):
    blocks = p.blocks
    for d, e in enumerate(p.spec):
        for a in reversed(_entry_axes(e)):
            blocks = all_gather(p.mesh, a, blocks, d)
    return blocks


def gather_placed(tree):
    """The whole tensors of a tree of :class:`Placed` leaves (every held
    rank's gathered copy equal: the first is returned); other leaves as
    they are.  A collective over the process mesh: every process calls
    it.  Outside autograd."""
    with torch.no_grad():
        if isinstance(tree, Placed):
            if tree.partial:
                raise ValueError("a partial sum has no whole value yet")
            return _gather_whole(tree)[0]
        if hasattr(tree, "items") and not isinstance(tree, torch.Tensor):
            return {k: gather_placed(v) for k, v in tree.items()}
        return tree


def gather_to_host(p: Placed) -> torch.Tensor:
    """The whole tensor of a placed leaf on the host, built block by block:
    each distinct block is copied off the device into its place, so no
    device holds more than its own blocks and one block in flight.  On a
    process mesh a collective (every process calls it, in the same leaf
    order, and gets the whole tensor): each block is broadcast from the
    lowest rank that holds it."""
    if p.partial:
        raise ValueError("a partial sum has no whole value yet")
    out = torch.empty(p.shape, dtype=p.dtype)
    at = lambda origin, shape: tuple(slice(o, o + n)
                                     for o, n in zip(origin, shape))
    with torch.no_grad():
        if not _is_device_mesh(p.mesh):
            for i, b in p.distinct():
                out[at(*p.geometry(i))] = b.detach().cpu()
            return out
        import torch.distributed as dist
        shape = block_shape(p.shape, p.spec, p.mesh)
        ranks = p.mesh.mesh
        owners = {}
        for coord in itertools.product(*(range(n) for n in ranks.shape)):
            owners.setdefault(block_origin(p.shape, p.spec, p.mesh, coord),
                              int(ranks[coord]))
        mine = p.blocks[0].detach().contiguous()
        for origin, src in owners.items():
            buf = (mine if src == dist.get_rank() else
                   torch.empty(shape, dtype=p.dtype, device=mine.device))
            dist.broadcast(buf, src=src)
            out[at(origin, shape)] = buf.cpu()
    return out


def _placed_leaves(tree) -> List[Placed]:
    if isinstance(tree, Placed):
        return [tree]
    if isinstance(tree, tuple):
        return [p for t in tree for p in _placed_leaves(t)]
    if hasattr(tree, "items") and not isinstance(tree, torch.Tensor):
        return [p for t in tree.values() for p in _placed_leaves(t)]
    return []


def held_bytes(tree) -> List[int]:
    """Bytes each held rank holds of a tree (dicts, tuples) of
    :class:`Placed` leaves (its blocks), in :func:`held_coords` order."""
    total = None
    for leaf in _placed_leaves(tree):
        sizes = [b.numel() * b.element_size() for b in leaf.blocks]
        total = sizes if total is None else [t + n for t, n in
                                             zip(total, sizes)]
    return total or []


def spec_bytes(struct, specs, mesh) -> int:
    """Bytes of one rank's blocks of a tree (dicts, tuples) of stand-ins
    (``shape``, ``dtype``) under a tree of specs: what :func:`held_bytes` gives every
    rank once the tree is placed."""
    if hasattr(struct, "shape"):
        n = math.prod(block_shape(struct.shape, specs, mesh))
        return n * torch.empty((), dtype=struct.dtype).element_size()
    if isinstance(struct, tuple):
        return sum(spec_bytes(s, sp, mesh) for s, sp in zip(struct, specs))
    return sum(spec_bytes(struct[k], specs[k], mesh) for k in struct)


def relayout(x: Placed, spec) -> Placed:
    """``x`` laid out by ``spec``: pending sums summed (a reduce-scatter
    where ``spec`` splits a dimension over the summed axis that ``x``
    holds whole, else a psum), then every dimension whose entry changes
    gathered over its old axes and sliced over its new ones.  The values
    are unchanged; autograd passes through with each move's transpose."""
    spec = tuple(spec)
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} for a tensor of rank {x.ndim}")
    mesh, blocks, cur = x.mesh, x.blocks, list(x.spec)
    for a in x.partial:
        dims = [d for d, e in enumerate(spec)
                if _entry_axes(e) == (a,) and cur[d] is None]
        if dims:
            blocks = reduce_scatter(mesh, a, blocks, dims[0])
            cur[dims[0]] = a
        else:
            blocks = psum(mesh, (a,), blocks)
    for d, e in enumerate(spec):
        if cur[d] is not None and _entry_axes(cur[d]) != _entry_axes(e):
            for a in reversed(_entry_axes(cur[d])):
                blocks = all_gather(mesh, a, blocks, d)
            cur[d] = None
    coords = held_coords(mesh)
    sizes = _axis_sizes(mesh)
    for d, e in enumerate(spec):
        if cur[d] is None and e is not None:
            axes = _entry_axes(e)
            n = math.prod(sizes[a] for a in axes)
            blocks = [b.chunk(n, d)[axis_index(mesh, c, axes)]
                      for b, c in zip(blocks, coords)]
            cur[d] = e
    return Placed(blocks, spec, mesh, x.shape)


def _shapes_dtypes(tree):
    leaves = tree_lib.leaves(tree)
    if not leaves:
        raise ValueError("a partitioner needs a non-empty tree")
    return (tuple(tuple(l.shape) for l in leaves),
            tuple(l.dtype for l in leaves))


class _FlatLayout:
    """The transforms both layouts share; a subclass gives
    ``leaf_offset(g)``, ``segments(j)`` (rank ``j``'s shard as ``(flat
    offset, shard offset, length)`` runs) and the sizes."""

    skeleton: object
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    n_shards: int

    def leaf_size(self, g: int) -> int:
        return math.prod(self.shapes[g])

    def flatten(self, tree, device=None) -> torch.Tensor:
        """Tree → fp32 ``[padded_size]``: each leaf at its offset, zeros
        everywhere else."""
        leaves = tree_lib.leaves(tree)
        device = device or leaves[0].device
        flat = torch.zeros(self.padded_size, dtype=torch.float32,
                           device=device)
        for g, leaf in enumerate(leaves):
            o = self.leaf_offset(g)
            flat[o:o + leaf.numel()].copy_(leaf.reshape(-1))
        return flat

    def unflatten(self, flat: torch.Tensor):
        """``[padded_size]`` → tree with the original shapes and dtypes (a
        copy; the padding is dropped)."""
        out = []
        for g, (shape, dtype) in enumerate(zip(self.shapes, self.dtypes)):
            o = self.leaf_offset(g)
            out.append(flat[o:o + self.leaf_size(g)].reshape(shape)
                       .to(dtype, copy=True))
        return tree_lib.from_leaves(self.skeleton, out)

    def views(self, flat: torch.Tensor):
        """The tree whose leaves are views into ``flat`` (fp32 only)."""
        return tree_lib.from_leaves(self.skeleton, [
            flat[self.leaf_offset(g):self.leaf_offset(g) + self.leaf_size(g)]
            .view(shape) for g, shape in enumerate(self.shapes)])

    def flat_view(self, tree, device=None):
        """``(flat, view tree)``: ``tree`` copied into a new fp32 flat
        buffer, and a tree of views into it that stands in for ``tree``
        (in place updates of either are updates of both).  Every leaf must
        be fp32: a view cannot change the dtype."""
        if any(d != torch.float32 for d in self.dtypes):
            raise TypeError("flat_view needs fp32 leaves, got "
                            f"{sorted({str(d) for d in self.dtypes})}")
        flat = self.flatten(tree, device)
        return flat, self.views(flat)

    def flat_of(self, tree) -> Optional[torch.Tensor]:
        """The flat buffer ``tree``'s leaves are views into, laid out as
        this partitioner lays them out, or ``None`` when they are not."""
        leaves = tree_lib.leaves(tree)
        if len(leaves) != len(self.shapes):
            return None
        storage = leaves[0].untyped_storage()
        if (storage.nbytes() != 4 * self.padded_size
                or leaves[0].dtype != torch.float32):
            return None
        for g, leaf in enumerate(leaves):
            if (leaf.dtype != torch.float32 or not leaf.is_contiguous()
                    or tuple(leaf.shape) != self.shapes[g]
                    or leaf.untyped_storage().data_ptr() != storage.data_ptr()
                    or leaf.storage_offset() != self.leaf_offset(g)):
                return None
        return leaves[0].as_strided((self.padded_size,), (1,), 0)

    def shard_segments(self, flat: torch.Tensor, index: int
                       ) -> List[torch.Tensor]:
        """Rank ``index``'s shard as views into ``flat``, one per run (one
        run for the plain layout; one per bucket for the aligned one)."""
        return [flat[fo:fo + n] for fo, _, n in self.segments(index)]

    def shard(self, flat: torch.Tensor, index: int) -> torch.Tensor:
        """Rank ``index``'s ``[shard_size]`` slice (a view when the shard
        is one run, else a copy)."""
        parts = self.shard_segments(flat, index)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def assemble(self, gathered: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The shards ``[n_shards, shard_size]`` (an all-gather's output) →
        the flat ``[padded_size]`` buffer (``out``, or a new one): the
        inverse of :meth:`shard`."""
        flat = out if out is not None else torch.empty(
            self.padded_size, dtype=gathered.dtype, device=gathered.device)
        for j in range(self.n_shards):
            for fo, so, n in self.segments(j):
                flat[fo:fo + n] = gathered[j, so:so + n]
        return flat

    def shard_from_tree(self, tree, index: int) -> torch.Tensor:
        """``shard(flatten(tree), index)`` without the flat copy of the
        whole tree: the fp32 ``[shard_size]`` shard built from the leaves
        it overlaps."""
        leaves = tree_lib.leaves(tree)
        out = torch.zeros(self.shard_size, dtype=torch.float32,
                          device=leaves[0].device)
        for fo, so, n in self.segments(index):
            for g, leaf in enumerate(leaves):
                lo, size = self.leaf_offset(g), leaf.numel()
                a, b = max(lo, fo), min(lo + size, fo + n)
                if a < b:
                    out[so + a - fo:so + b - fo] = leaf.reshape(-1)[a - lo:b - lo]
        return out


@dataclasses.dataclass(frozen=True)
class ZeroPartitioner(_FlatLayout):
    """Padded 1-D layout that shards any tree across ``n_shards`` ranks.

    The leaves are packed back to back in flatten order (sorted keys), the
    vector zero-padded to a multiple of ``n_shards`` and cut into equal
    contiguous shards: shard boundaries ignore leaf boundaries, so
    non-divisible leaves, scalars and leaves smaller than the axis all
    shard.  The compressed legs over this layout take one global wire
    format (:func:`~repro_torch.dist.collectives.dps_reduce_scatter_mean`,
    :func:`~repro_torch.dist.collectives.dps_allgather_params`).
    """

    skeleton: object
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    n_shards: int

    @staticmethod
    def create(tree, n_shards: int) -> "ZeroPartitioner":
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        shapes, dtypes = _shapes_dtypes(tree)
        return ZeroPartitioner(tree_lib.map_tree(lambda _: None, tree),
                               shapes, dtypes, int(n_shards))

    @property
    def size(self) -> int:
        """Unpadded element count of the flattened tree."""
        return sum(math.prod(s) for s in self.shapes)

    @property
    def shard_size(self) -> int:
        return -(-self.size // self.n_shards)

    @property
    def padded_size(self) -> int:
        return self.shard_size * self.n_shards

    def leaf_offset(self, g: int) -> int:
        return sum(math.prod(s) for s in self.shapes[:g])

    def segments(self, index: int):
        return [(index * self.shard_size, 0, self.shard_size)]


@dataclasses.dataclass(frozen=True)
class GroupAlignedPartitioner(_FlatLayout):
    """ZeRO-1 flat layout whose leaf slots are padded to the wire quantum.

    The plain layout packs leaves back to back, so shard boundaries
    straddle leaves and the flat vector cannot carry one wire ⟨IL, FL⟩ per
    leaf.  This one keeps the plain layout's contract but reuses
    :class:`~repro_torch.dist.collectives.GroupLayout`'s alignment:

    * the leaves are grouped into ``buckets``, contiguous runs of leaf
      indices in flatten order (one run over every leaf unless the
      overlapped wire's :class:`~repro_torch.dist.overlap.BucketPlan` is
      given);
    * within a bucket every leaf slot is padded to the bucket's quantum,
      and the bucket to ``n_shards`` chunks of whole quanta, so a chunk
      never straddles a leaf and every tile maps to one leaf;
    * the flat vector is the buckets one after the other (bucket-major),
      and rank ``r``'s shard the concatenation of its chunk of each bucket,
      so the sharded legs run the grouped codec bucket by bucket while the
      optimizer still sees one ``[shard_size]`` slice.

    All fields are Python values.
    """

    skeleton: object
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    n_shards: int
    buckets: Tuple[Tuple[int, ...], ...]
    layouts: Tuple[GroupLayout, ...]

    @staticmethod
    def create(tree, n_shards: int, *, quantum: Optional[int] = None,
               buckets: Optional[Sequence[Sequence[int]]] = None
               ) -> "GroupAlignedPartitioner":
        """``buckets``: contiguous leaf-index runs in any order (stored in
        flatten order), e.g. a :class:`BucketPlan`'s; ``None`` is one bucket
        over the tree.  Each bucket takes
        :func:`~repro_torch.dist.collectives.default_wire_quantum` of its
        own size and leaf count unless ``quantum`` pins one."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        shapes, dtypes = _shapes_dtypes(tree)
        sizes = [math.prod(s) or 1 for s in shapes]
        if buckets is None:
            runs = (tuple(range(len(shapes))),)
        else:
            runs = tuple(tuple(int(i) for i in r)
                         for r in sorted(buckets, key=lambda r: r[0]))
            if [i for r in runs for i in r] != list(range(len(shapes))):
                raise ValueError(
                    "buckets must partition the leaves into contiguous "
                    f"ascending runs, got {runs}")
        layouts = []
        for run in runs:
            b_sizes = tuple(sizes[i] for i in run)
            q = quantum or default_wire_quantum(sum(b_sizes), len(run))
            layouts.append(group_layout(b_sizes, n_chunks=n_shards,
                                        quantum=q))
        return GroupAlignedPartitioner(
            tree_lib.map_tree(lambda _: None, tree), shapes, dtypes,
            int(n_shards), runs, tuple(layouts))

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def size(self) -> int:
        """Unpadded element count of the flattened tree."""
        return sum(math.prod(s) or 1 for s in self.shapes)

    @property
    def padded_size(self) -> int:
        """Flat-buffer length: the aligned buckets' totals."""
        return sum(l.total for l in self.layouts)

    @property
    def shard_size(self) -> int:
        """Per-rank slice length: the aligned buckets' chunks."""
        return sum(l.chunk for l in self.layouts)

    def bucket_offset(self, b: int) -> int:
        """Flat-buffer offset of bucket ``b``."""
        return sum(l.total for l in self.layouts[:b])

    def shard_offset(self, b: int) -> int:
        """Offset of bucket ``b``'s chunk within a rank's shard."""
        return sum(l.chunk for l in self.layouts[:b])

    def leaf_range(self, b: int) -> Tuple[int, int]:
        """Global leaf-index range ``[lo, hi)`` of bucket ``b``: the rows
        of a per-leaf ``[G]`` format table it consumes."""
        run = self.buckets[b]
        return run[0], run[-1] + 1

    def leaf_offset(self, g: int) -> int:
        """Flat-buffer offset of leaf ``g``'s aligned slot."""
        for b, run in enumerate(self.buckets):
            if g in run:
                return (self.bucket_offset(b)
                        + self.layouts[b].offsets[run.index(g)])
        raise IndexError(g)

    def segments(self, index: int):
        return [(self.bucket_offset(b) + index * lay.chunk,
                 self.shard_offset(b), lay.chunk)
                for b, lay in enumerate(self.layouts)]


# ---------------------------------------------------------------------------
# The mesh + rules context.
# ---------------------------------------------------------------------------

# The bindings, process-wide: the reference's stack is per thread, but
# torch's autograd runs a CUDA backward, and the recompute of a
# checkpointed block in it, on a device thread of its own, which must see
# the mesh the forward saw.
_STACK: List[tuple] = []


@contextlib.contextmanager
def axis_rules(mesh, rules: LogicalRules):
    """Bind ``(mesh, rules)`` for :func:`logical_constraint`,
    :func:`model_axis_size` and the MoE layer's dispatch."""
    _STACK.append((mesh, rules))
    try:
        yield mesh, rules
    finally:
        _STACK.pop()


def current_mesh_rules():
    """The innermost ``axis_rules`` binding, or ``(None, None)``."""
    if _STACK:
        return _STACK[-1]
    return None, None


def model_axis_size() -> int:
    """Size of the bound mesh's "model" axis (1 outside any binding)."""
    mesh, _ = current_mesh_rules()
    if mesh is None:
        return 1
    return int(_axis_sizes(mesh).get("model", 1))


def logical_constraint(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names.  On a
    :class:`Placed` tensor a real re-layout (:func:`relayout` to the spec
    the bound rules give on its mesh, the default rules without a
    binding); on a whole tensor a layout, not a value, so ``x`` itself
    (under a binding the spec is resolved all the same: a logical tuple of
    the wrong rank raises)."""
    mesh, rules = current_mesh_rules()
    if isinstance(x, Placed):
        rules = rules or LogicalRules()
        return relayout(x, rules.spec(logical, x.shape, x.mesh))
    if mesh is not None:
        rules.spec(logical, x.shape, mesh)
    return x
