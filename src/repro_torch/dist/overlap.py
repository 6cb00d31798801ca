"""Backward-overlapped bucketed wire: one compressed collective per bucket.

Counterpart of ``repro/dist/overlap.py``.  The monolithic tree collective
(:class:`~repro_torch.dist.collectives.TreeAllReduce`) ships every gradient
leaf in ONE int8 payload, so no wire byte moves before the whole backward
has finished.  Here the gradient tree splits into DDP-style **buckets**,
contiguous runs of leaves, and each bucket runs its own compressed
collective in the order the backward produces them (last layer first):

* :class:`BucketedWire` takes a rank's gradient leaf the moment the
  backward has it (the train step calls :meth:`BucketedWire.encode_leaf`
  from a post-accumulate-grad hook: the readiness tap of the reference
  becomes a real hook), encodes it into its bucket's payload and drops it.
  Once every rank this process holds has encoded a bucket, its
  ``all_to_all`` is issued — asynchronously on a process group, waited on
  before its K4 — and on the stacked transport its K4 and leg-2 snap run
  right away, while the backward goes on.
* :func:`bucketed_allreduce_mean_tree`: the bucketed all-reduce.
* :func:`zero_bucketed_reduce_scatter` and :func:`zero_allgather_params`:
  the two ZeRO-1 halves over a
  :class:`~repro_torch.dist.sharding.GroupAlignedPartitioner`'s buckets.

Determinism: leg-1 streams are keyed by (rank, GLOBAL leaf index) and
leg-2 streams by global leaf index at the element's index in the leaf, as
in the monolithic collective, and K4's sums are exact; so a bucketed or
sharded result is bit-equal to the monolithic one under both rounding
modes, whatever order the hooks fire in.  Statistics come back in global
leaf order.

The verifier's bucket landmarks (``wire_bucket``, :mod:`repro_torch.core.
tagging`): ``stage="ready"`` on each rank's leaf as it is handed to its
bucket's encode, ``stage="mean"`` on each bucket's decoded mean (or an
owner's decoded chunk of it), with ``bucket``, ``n`` (the bucket count),
``leaf`` and ``rank``; the train step's hooks add ``stage="grad"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import tagging
from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import (FixedPointFormat, QuantStats,
                                          ROUND_STOCHASTIC, fold_seed,
                                          merge_stats)
from repro_torch.dist.collectives import (TreeAllReduce, _aligned_bits,
                                          _decode_aligned, _encode_aligned,
                                          _layout_mask, _layout_tables,
                                          _resolve_backend, _validate_capacity,
                                          resolve_domain_format)

# Default bucket granularity, in elements (the reference's): a LeNet-scale
# tree still splits into a few buckets.
DEFAULT_BUCKET_ELEMS = 1 << 16

# The parameter all-gather's stream salt ("WPLG"), as the reference folds it.
WPLG = 0x57504C47


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static assignment of gradient-tree leaves to wire buckets.

    ``buckets[b]`` is the ascending, contiguous run of global leaf indices
    (flatten order) that bucket ``b`` syncs; buckets are listed in **ready
    order** — reverse flatten order, because the backward produces the last
    layer's gradients first.
    """

    sizes: Tuple[int, ...]                # per-leaf element counts
    buckets: Tuple[Tuple[int, ...], ...]  # ready-order leaf-index runs
    target: int                           # requested elements per bucket

    def __post_init__(self):
        n = len(self.sizes)
        if not self.buckets and n:
            raise ValueError("empty bucket list for a non-empty tree")
        flat = [g for b in self.buckets for g in b]
        if sorted(flat) != list(range(n)):
            raise ValueError(
                f"buckets {self.buckets} are not a partition of the {n} "
                "leaves: every leaf must appear exactly once")
        stop = n
        for b, run in enumerate(self.buckets):
            if not run:
                raise ValueError(f"bucket {b} is empty")
            if list(run) != list(range(run[0], run[0] + len(run))):
                raise ValueError(f"bucket {b} = {run} is not a contiguous "
                                 "ascending run of leaf indices")
            if run[-1] != stop - 1:
                raise ValueError(
                    "buckets must cover leaves in reverse flatten order (the "
                    f"backward's ready order): bucket {b} ends at leaf "
                    f"{run[-1]}, expected {stop - 1}")
            stop = run[0]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    def bucket_of(self, leaf: int) -> int:
        """The bucket index owning global leaf ``leaf``."""
        for b, run in enumerate(self.buckets):
            if run[0] <= leaf <= run[-1]:
                return b
        raise IndexError(f"leaf {leaf} not in any bucket")

    def bucket_elems(self, b: int) -> int:
        return sum(self.sizes[g] for g in self.buckets[b])


def plan_buckets(sizes, target_elems: int = DEFAULT_BUCKET_ELEMS
                 ) -> BucketPlan:
    """Greedy reverse-order bucketing: walk the leaves from the LAST flatten
    index down, opening a new bucket whenever the current one would pass
    ``target_elems``; every bucket gets at least one leaf, so a leaf larger
    than the target is a bucket of its own."""
    sizes = tuple(int(s) for s in sizes)
    if target_elems < 1:
        raise ValueError(f"target_elems must be >= 1, got {target_elems}")
    buckets, run, acc = [], [], 0
    for g in range(len(sizes) - 1, -1, -1):
        if run and acc + sizes[g] > target_elems:
            buckets.append(tuple(reversed(run)))
            run, acc = [], 0
        run.append(g)
        acc += sizes[g]
    if run:
        buckets.append(tuple(reversed(run)))
    return BucketPlan(sizes=sizes, buckets=tuple(buckets),
                      target=int(target_elems))


def _bucket_format(fmt: FixedPointFormat, lo: int, hi: int
                   ) -> FixedPointFormat:
    """Rows ``[lo, hi)`` of a per-leaf ``[G]`` table; a scalar format as
    it is (the bucket's collective broadcasts it where it needs rows)."""
    if fmt.il.ndim == 0:
        return fmt
    return FixedPointFormat(fmt.il[lo:hi], fmt.fl[lo:hi])


class BucketedWire:
    """The bucketed wire of one step, fed leaf by leaf, rank by rank.

    ``like``: the gradient tree's structure (a tree of tensors with the
    gradients' shapes and dtypes).  ``runs``: flatten-order leaf runs, one
    per bucket; the collectives run in ready order (reverse).  ``layouts``:
    each bucket's group-aligned layout (a ZeRO partitioner's), or ``None``
    for the all-reduce's own.  ``eager``: run a bucket's reduce-scatter
    half as soon as it is complete (the overlapped schedule); else
    :meth:`finish_scatter` runs them all.
    """

    def __init__(self, like, formats, transport, seed: int, *,
                 runs: Sequence[Sequence[int]], layouts=None,
                 mode: str = ROUND_STOCHASTIC, backend: str = "auto",
                 domain: str = "wire_grads", quantum: Optional[int] = None,
                 onchip_prng: bool = True, eager: bool = True):
        fmt = resolve_domain_format(formats, domain)
        _validate_capacity(fmt)
        leaves = tree_lib.leaves(like)
        self.grouped = fmt.il.ndim != 0
        if self.grouped and fmt.il.shape[0] != len(leaves):
            raise ValueError(
                f"[G]-shaped tree formats are one ⟨IL, FL⟩ per leaf: the "
                f"table has {fmt.il.shape[0]} rows, the tree {len(leaves)} "
                "leaves")
        self.runs = [tuple(r) for r in runs]
        if [g for r in self.runs for g in r] != list(range(len(leaves))):
            raise ValueError(f"runs {self.runs} must cover the leaves in "
                             "flatten order")
        self.skeleton = tree_lib.map_tree(lambda _: None, like)
        self.transport, self.eager = transport, eager
        self.rows = list(transport.ranks)
        self.buckets = []
        for b, run in enumerate(self.runs):
            lo, hi = run[0], run[-1] + 1
            self.buckets.append(TreeAllReduce(
                leaves[lo:hi], _bucket_format(fmt, lo, hi), transport, seed,
                mode=mode, backend=backend, quantum=quantum,
                onchip_prng=onchip_prng, group_base=lo,
                layout=None if layouts is None else layouts[b]))
        self.bucket_of = {g: b for b, run in enumerate(self.runs) for g in run}
        self.domain = domain
        # the verifier's bucket landmarks mark the overlapped schedule; a
        # group-aligned layout run after the backward is the monolithic
        # wire in bucket form, as the reference's step runs it untagged
        self.landmarks = eager
        self.left = [len(run) * len(self.rows) for run in self.runs]
        self.next = len(self.runs) - 1          # next bucket in ready order
        self.n_leaves = len(leaves)

    def encode_leaf(self, rank: int, g: int, leaf: torch.Tensor):
        """Leg 1 of ``rank``'s global leaf ``g``; the caller may drop the
        leaf after.  A leaf encoded twice raises."""
        b = self.bucket_of[g]
        tw = self.buckets[b]
        j = g - self.runs[b][0]
        if tw.leaf_stats[tw.rows.index(rank)][j] is not None:
            raise RuntimeError(f"leaf {g} of rank {rank} encoded twice")
        if self.landmarks:
            tagging.tag(leaf, "wire_bucket", stage="ready", bucket=b,
                        n=len(self.runs), leaf=g, rank=rank,
                        domain=self.domain)
        tw.encode_leaf(rank, j, leaf)
        self.left[b] -= 1
        # issue complete buckets in ready order, so every process issues
        # its collectives in the same order whatever order leaves arrive
        while self.next >= 0 and self.left[self.next] == 0:
            tw = self.buckets[self.next]
            tw.start()
            if self.eager and tw._work is None:
                tw.scatter_snap()
            self.next -= 1

    def encode(self, rank: int, tree):
        for g, leaf in enumerate(tree_lib.leaves(tree)):
            self.encode_leaf(rank, g, leaf)

    def missing(self, rank: int) -> List[int]:
        """Global leaves of ``rank`` not encoded yet."""
        row = self.rows.index(rank)
        return [run[0] + j for b, run in enumerate(self.runs)
                for j, s in enumerate(self.buckets[b].leaf_stats[row])
                if s is None]

    def rank_stats(self, row: int) -> QuantStats:
        """Row ``row``'s dispatch-leg stats in global leaf order:
        ``[G]``-stacked, or merged for a scalar format."""
        per_leaf = [s for tw in self.buckets for s in tw.leaf_stats[row]]
        if any(s is None for s in per_leaf):
            raise RuntimeError("encode every leaf of every rank the "
                               "transport holds first")
        if self.grouped:
            out = QuantStats(*(torch.stack([getattr(s, f.name)
                                            for s in per_leaf])
                               for f in dataclasses.fields(QuantStats)))
        else:
            out = merge_stats(*per_leaf)
        return tagging.tag_tree(out, "wire_stats", domain=self.domain)

    @property
    def stats(self) -> List[QuantStats]:
        return [self.rank_stats(i) for i in range(len(self.rows))]

    def finish_scatter(self):
        """The reduce-scatter half of every bucket not yet run, in ready
        order (waiting on each bucket's all-to-all before its K4)."""
        for tw in reversed(self.buckets):
            tw.scatter_snap()

    def owner_segments(self, i: int) -> List[torch.Tensor]:
        """Owner row ``i``'s fp32 chunk of every bucket, in flatten order:
        its shard of the mean, one segment per bucket."""
        self.finish_scatter()
        segs = [tw.decode_owned(i) for tw in self.buckets]
        if self.landmarks:
            for b, seg in enumerate(segs):
                tagging.tag(seg, "wire_bucket", stage="mean", bucket=b,
                            n=len(self.runs), domain=self.domain)
        return segs

    def finish(self):
        """The all-reduce: ``(mean tree, stats per rank held)``."""
        stats = self.stats
        self.finish_scatter()
        out = [None] * self.n_leaves
        for b in reversed(range(len(self.buckets))):
            means, _ = self.buckets[b].finish()
            for j, m in enumerate(means):
                if self.landmarks:
                    tagging.tag(m, "wire_bucket", stage="mean", bucket=b,
                                n=len(self.runs), domain=self.domain)
                out[self.runs[b][0] + j] = m
        return tree_lib.from_leaves(self.skeleton, out), stats


def bucketed_allreduce_mean_tree(trees: Sequence, formats, transport,
                                 seed: int, *, mode: str = ROUND_STOCHASTIC,
                                 backend: str = "auto",
                                 domain: str = "wire_grads",
                                 quantum: Optional[int] = None,
                                 plan: Optional[BucketPlan] = None,
                                 target_elems: int = DEFAULT_BUCKET_ELEMS,
                                 onchip_prng: bool = True):
    """Bucketed :func:`~repro_torch.dist.collectives.dps_allreduce_mean_tree`:
    one compressed ``all_to_all``/``all_gather`` pair per bucket of
    ``plan`` (default :func:`plan_buckets` over the leaf sizes), in ready
    order.  Same contract, and bit-equal to it under both rounding modes:
    ``(mean tree, stats per rank held)``."""
    leaves = tree_lib.leaves(trees[0])
    sizes = tuple(l.numel() for l in leaves)
    if plan is None:
        plan = plan_buckets(sizes, target_elems)
    elif plan.sizes != sizes:
        raise ValueError(f"bucket plan was built for leaf sizes {plan.sizes} "
                         f"but the tree has {sizes}")
    if len(trees) != len(transport.ranks):
        raise ValueError(f"{len(trees)} trees for the "
                         f"{len(transport.ranks)} ranks this transport holds")
    bw = BucketedWire(trees[0], formats, transport, seed,
                      runs=sorted(plan.buckets), mode=mode, backend=backend,
                      domain=domain, quantum=quantum, onchip_prng=onchip_prng)
    for r, tree in zip(transport.ranks, trees):
        bw.encode(r, tree)
    return bw.finish()


def zero_wire(like, formats, transport, seed: int, *, part,
              mode: str = ROUND_STOCHASTIC, backend: str = "auto",
              domain: str = "wire_grads", onchip_prng: bool = True,
              eager: bool = False) -> BucketedWire:
    """The bucketed wire over a group-aligned ZeRO partitioner's buckets
    and layouts (a scalar format runs them as identical rows)."""
    _check_partitioner(part, transport, len(tree_lib.leaves(like)),
                       resolve_domain_format(formats, domain))
    return BucketedWire(like, formats, transport, seed, runs=part.buckets,
                        layouts=part.layouts, mode=mode, backend=backend,
                        domain=domain, onchip_prng=onchip_prng, eager=eager)


def _check_partitioner(part, transport, n_leaves: int, fmt):
    if transport.axis_size != part.n_shards:
        raise ValueError(f"partitioner has n_shards={part.n_shards} but the "
                         f"data axis has {transport.axis_size} ranks")
    if len(part.shapes) != n_leaves:
        raise ValueError(f"partitioner covers {len(part.shapes)} leaves, got "
                         f"{n_leaves}")
    if fmt.il.ndim != 0 and fmt.il.shape[0] != n_leaves:
        raise ValueError(
            f"[G]-shaped formats are one ⟨IL, FL⟩ per leaf: the table has "
            f"{fmt.il.shape[0]} rows, the tree {n_leaves} leaves")


def zero_bucketed_reduce_scatter(trees: Sequence, formats, transport,
                                 seed: int, *, part,
                                 mode: str = ROUND_STOCHASTIC,
                                 backend: str = "auto",
                                 domain: str = "wire_grads",
                                 onchip_prng: bool = True):
    """Compressed gradient reduce-scatter onto a group-aligned ZeRO shard.

    The sharded first half of :func:`bucketed_allreduce_mean_tree`: one
    int8 ``all_to_all`` per bucket of ``part`` (a
    :class:`~repro_torch.dist.sharding.GroupAlignedPartitioner`), in ready
    order, each followed by K4 on the owned chunk and a LOCAL wire-grid
    snap (the leg-2 re-encode, without the gather) that the owner decodes.
    So owner ``j`` holds values bit-equal to its shard of the all-reduce's
    mean (``part.shard(part.flatten(mean), j)``) under both rounding modes.
    ``formats`` may be scalar or per-leaf ``[G]``; stats come back in that
    shape, in global leaf order.

    Returns ``(gshards fp32 [rows, part.shard_size], stats per rank
    held)``.
    """
    bw = zero_wire(trees[0], formats, transport, seed, part=part, mode=mode,
                   backend=backend, domain=domain, onchip_prng=onchip_prng)
    for r, tree in zip(transport.ranks, trees):
        bw.encode(r, tree)
    stats = bw.stats
    gshards = torch.stack([torch.cat(bw.owner_segments(i))
                           for i in range(len(bw.rows))])
    return gshards, stats


def zero_allgather_params(shards, formats, transport, seed: int, *,
                          part, mode: str = ROUND_STOCHASTIC,
                          backend: str = "auto", domain: str = "wire_params",
                          onchip_prng: bool = True,
                          out: Optional[torch.Tensor] = None, keep=None):
    """Compressed parameter all-gather from group-aligned ZeRO shards.

    ``shards``: per rank held, its ``[part.shard_size]`` slice of the
    updated flat parameters, or that slice as per-bucket segments
    (``part.shard_segments``).  Each bucket segment is encoded with the
    aligned codec — K3 (K3b with ``onchip_prng``) with statistics, the
    owner's chunk of the layout's mask keeping the alignment padding out —
    under the bucket's rows of the format (a scalar format broadcast); the
    bits of group ``g`` are the stream of ``fold_seed(fold_seed(seed,
    WPLG), g)`` at the element's index in the leaf, whichever rank owns it.
    ONE int8 ``all_gather`` of the ``[shard_size]`` rows follows, and the
    aligned decode of the flat buffer.

    Returns ``(flat fp32 [part.padded_size], stats per rank held)`` —
    ``[G]`` rows in leaf order, or collapsed to one for a scalar format.
    ``out`` receives the decode; it may be the buffer the shards view:
    every shard is encoded before the decode writes.  ``shards`` may also
    be a callable ``(row, rank) -> shard``, called for each rank held in
    order just before its encode.  ``keep`` (a bool device scalar, the
    health guards' skip gate): the decode writes ``out`` only where it
    holds.
    """
    fmt = resolve_domain_format(formats, domain)
    _validate_capacity(fmt)
    _check_partitioner(part, transport, len(part.shapes), fmt)
    rows = list(transport.ranks)
    if not callable(shards) and len(shards) != len(rows):
        raise ValueError(f"{len(shards)} shards for the {len(rows)} ranks "
                         "this transport holds")
    dev = fmt.il.device
    grouped = fmt.il.ndim != 0
    kps = fold_seed(seed, WPLG)
    S = part.shard_size
    wire = torch.empty(len(rows), S, dtype=torch.int8, device=dev)
    stats = []
    for i, j in enumerate(rows):
        shard = shards(i, j) if callable(shards) else shards[i]
        segs = (list(shard) if isinstance(shard, (list, tuple))
                else [shard[so:so + n] for _, so, n in part.segments(j)])
        stat_rows = []
        for b, (lay, seg) in enumerate(zip(part.layouts, segs)):
            lo, hi = part.leaf_range(b)
            fmt_b = _rows(fmt, lo, hi)
            be = _resolve_backend(backend, seg.device)
            tg_all, goff = _layout_tables(lay, str(seg.device))
            tpc = lay.chunk // lay.quantum
            my_mask = _layout_mask(lay, seg.device)[j * lay.chunk:
                                                    (j + 1) * lay.chunk]
            bits = (_aligned_bits(kps, lay, goff, j * lay.chunk, lay.chunk,
                                  onchip_prng=onchip_prng, group_base=lo)
                    if mode == ROUND_STOCHASTIC else None)
            so = part.shard_offset(b)
            _, s = _encode_aligned(seg, fmt_b, tg_all[j * tpc:(j + 1) * tpc],
                                   my_mask, bits=bits, mode=mode, backend=be,
                                   quantum=lay.quantum,
                                   out=wire[i, so:so + lay.chunk])
            stat_rows.append(s)
        del shard, segs
        st = QuantStats(*(torch.cat([getattr(s, f.name) for s in stat_rows])
                          for f in dataclasses.fields(QuantStats)))
        if not grouped:     # a scalar wire_params domain: one row
            st = QuantStats(*(getattr(st, f).sum() for f in (
                "count", "nonzero", "overflow", "abs_err_sum", "rel_err_sum",
                "abs_sum")), max_abs=st.max_abs.max())
        stats.append(st)
    tagging.tag(wire, "wire_payload", leg="gather", domain=domain)
    gathered = transport.all_gather(wire).view(part.n_shards, S)
    del wire
    if out is None:
        out = torch.empty(part.padded_size, dtype=torch.float32, device=dev)
    for b, lay in enumerate(part.layouts):
        lo, hi = part.leaf_range(b)
        tg_all, _ = _layout_tables(lay, str(dev))
        tpc = lay.chunk // lay.quantum
        so, bo = part.shard_offset(b), part.bucket_offset(b)
        for j in range(part.n_shards):      # one fp32 chunk at a time
            dst = out[bo + j * lay.chunk:bo + (j + 1) * lay.chunk]
            dec = _decode_aligned(
                gathered[j, so:so + lay.chunk], _rows(fmt, lo, hi),
                tg_all[j * tpc:(j + 1) * tpc], lay.quantum)
            if keep is None:
                dst.copy_(dec)
            else:
                torch.where(keep, dec, dst, out=dst)
    return out, tagging.tag_tree(stats, "wire_stats", domain=domain)


def _rows(fmt: FixedPointFormat, lo: int, hi: int) -> FixedPointFormat:
    """Rows ``[lo, hi)`` of a ``[G]`` table, or a scalar format broadcast
    to ``hi - lo`` identical rows (the aligned codec reads a row table)."""
    if fmt.il.ndim != 0:
        return FixedPointFormat(fmt.il[lo:hi], fmt.fl[lo:hi])
    return FixedPointFormat(fmt.il.reshape(1).expand(hi - lo),
                            fmt.fl.reshape(1).expand(hi - lo))
