"""ZeRO-1 flat layouts: the optimizer state of a parameter tree, sharded.

Counterpart of the ZeRO half of ``repro/dist/sharding.py``
(``ZeroPartitioner``, ``GroupAlignedPartitioner``); the GSPMD placement
rules of its other half (``LogicalRules``, ``tree_specs``,
``logical_constraint``) wait for a tensor-parallel slice.

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

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.dist.collectives import (GroupLayout, default_wire_quantum,
                                          group_layout)


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
