"""A mesh axis the collectives run over: counterpart of ``shard_map`` over
a mesh axis (the wire's ``data`` axis, the MoE dispatch's ``model`` axis)
and of the ``lax`` collectives the reference calls inside it.

A *transport* knows the axis size ``n``, the ranks this process holds, and
moves the wire's payloads between ranks.  Every payload carries a leading
axis of the ranks this process holds (``len(transport.ranks)`` rows):

* :class:`StackedTransport` — ``n`` ranks in one process, on one device.
  Each rank's work (its forward and backward, its encode, the decode-reduce
  of the chunk it owns) runs as in an ``n``-process run, with the same
  launches, shapes and bytes; the interconnect's copy is what is missing:
  ``all_to_all`` hands owner ``j`` the strided view of column block ``j`` of
  the ``[n, n·chunk]`` stack, and the gathered leg-2 buffer is the one
  ``[n·chunk]`` buffer the owners wrote their chunks into.
* :class:`ProcessGroupTransport` — one rank per process over
  ``torch.distributed`` (NCCL between cards, gloo on the CPU):
  ``all_to_all_single`` and ``all_gather_into_tensor`` on the int8 payloads,
  ``all_reduce`` for the statistics.

:meth:`all_to_all_tiled` is ``lax.all_to_all(..., tiled=True)``, through
which autograd passes (the MoE layer's expert-parallel dispatch): a
permute of the stacked rank blocks, or ``all_to_all_single`` in an
autograd function whose backward is the same all-to-all of the gradient.
:meth:`ProcessGroupTransport.gather_rows` is the all-gather autograd
passes through (its backward sums every rank's gradient of a row into the
row's owner).

**The placed step's collectives** (:mod:`repro_torch.dist.sharding`'s
``Placed`` tensors): each takes the blocks of the ranks of ONE group of the
axis that this process holds (every rank of the group on a stacked
transport, its own on a process group) as a list, and returns a list the
same way.  Each passes autograd with the exact transpose of what it
computes, so every rank's backward is its share of the whole program's:

* :meth:`gather_blocks` — all-gather along a dim; backward reduce-scatter;
* :meth:`reduce_scatter_blocks` — reduce-scatter along a dim; backward
  all-gather;
* :meth:`psum_blocks` — the sum over the axis; backward the sum again
  (``grad="psum"``) or the identity (``grad="identity"``, Megatron's
  ``g``); :meth:`copy_blocks` is its conjugate (identity forward, the sum
  backward: Megatron's ``f``); :meth:`pmax_blocks` the max, outside
  autograd.

Under :func:`shared_outputs` (the placed serving steps, outside autograd)
a stacked axis hands every rank of a group the ONE tensor a gather or a
sum makes, so that rank-by-rank work on the replicated result runs once
(``Placed.map`` computes once for ranks whose inputs are the same
tensors); the values are the same either way.  The placed train step
keeps a tensor a rank.

On a stacked axis and on a gloo group every sum runs in rank order,
``((x0 + x1) + x2) + ...`` (the gloo group all-gathers and adds in that
order, receiving and holding ``n`` times the tensor), so the two give the
same bits (bf16 blocks add in bf16).  On any other backend (NCCL) the
reduce-scatter and the sums are the library's ``reduce_scatter_tensor``
and ``all_reduce``, which hold no ``n``-fold buffer and sum in their own
order.

With a :class:`~repro_torch.analysis.trace.Trace` open, every collective
(backward ones included) is one node of it, with its payload's dtype and one
rank's bytes; the ops a stacked axis runs to emulate the move are not
recorded.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from repro_torch.core import tagging

_SHARED = [False]


def _rec(op: str, xs, fn, scale: int = 1, rows: int = 1):
    """``fn()`` recorded as one collective ``op`` over ``xs`` (a tensor, or
    a list whose None entries are skipped): one rank's payload is ``scale``
    times the bytes of the first tensor over ``rows`` (a stacked payload's
    ranks)."""
    if tagging.active() is None:
        return fn()
    xs = [xs] if isinstance(xs, torch.Tensor) else [t for t in xs
                                                    if t is not None]
    x = xs[0]
    return tagging.collective(op, xs, fn, dtype=x.dtype,
                              nbytes=scale * x.numel() // rows * x.element_size())


@contextlib.contextmanager
def shared_outputs():
    """Outside autograd, a stacked axis's :meth:`StackedTransport.
    gather_blocks` and :meth:`StackedTransport.psum_blocks` hand every
    rank of a group one tensor while this is open."""
    saved, _SHARED[0] = _SHARED[0], True
    try:
        yield
    finally:
        _SHARED[0] = saved


def _share() -> bool:
    return _SHARED[0] and not torch.is_grad_enabled()


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks along dim 0; its gradient
    travels back the same way."""

    @staticmethod
    def forward(ctx, send, group):
        import torch.distributed as dist
        ctx.group = group
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv

    @staticmethod
    def backward(ctx, g):
        return _rec("all-to-all", [g], lambda: _AllToAll.apply(
            g.contiguous(), ctx.group)), None


class _GatherRows(torch.autograd.Function):
    """Every rank's ``t`` stacked ``[n, ...]``; the gradient of row r, summed
    over the ranks, goes back to rank r."""

    @staticmethod
    def forward(ctx, t, group, rank, n):
        import torch.distributed as dist
        ctx.group, ctx.rank = group, rank
        out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous().reshape(-1),
                                    group=group)
        return out.view((n,) + tuple(t.shape))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        _rec("all-reduce", [g], lambda: dist.all_reduce(
            g, op=dist.ReduceOp.SUM, group=ctx.group))
        return g[ctx.rank], None, None, None


def _ordered_sum(parts):
    """``((p0 + p1) + p2) + ...`` over the parts that are not None (a rank
    whose output the loss did not reach), or None when all are."""
    out = None
    for t in parts:
        if t is not None:
            out = t if out is None else out + t
    return out


def _shared(y, n):
    """``n`` outputs of one value: ``y`` itself, then views of it (a
    Function's outputs must be distinct tensors)."""
    return tuple(y if i == 0 else y.view_as(y) for i in range(n))


class _StackedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.n = dim, len(xs)
        return _shared(torch.cat(xs, dim), len(xs))

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return (None,) * (ctx.n + 1)
        return (None,) + _rec("reduce-scatter", gs, lambda: tuple(
            p.contiguous() for p in _ordered_sum(gs).chunk(ctx.n, ctx.dim)))


class _StackedReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.n = dim, len(xs)
        return tuple(p.contiguous()
                     for p in _ordered_sum(xs).chunk(len(xs), dim))

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)

        def gather():
            return _shared(torch.cat([torch.zeros_like(like) if g is None
                                      else g for g in gs], ctx.dim), ctx.n)
        return (None,) + _rec("all-gather", gs, gather, scale=ctx.n)


class _StackedPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, identity, *xs):
        ctx.identity, ctx.n = identity, len(xs)
        return _shared(_ordered_sum(xs), len(xs))

    @staticmethod
    def backward(ctx, *gs):
        if ctx.identity:
            return (None,) + gs
        if all(g is None for g in gs):
            return (None,) * (ctx.n + 1)
        return (None,) + _rec("all-reduce", gs,
                              lambda: _shared(_ordered_sum(gs), ctx.n))


class _StackedCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.n = len(xs)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return (None,) * ctx.n
        return _rec("all-reduce", gs,
                    lambda: _shared(_ordered_sum(gs), ctx.n))


def _check_group(xs, n):
    if len(xs) != n:
        raise ValueError(f"a stacked axis of {n} ranks takes {n} blocks, "
                         f"got {len(xs)}")


class StackedTransport:
    """``n`` data-parallel ranks held by this process."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a data axis needs at least one rank, got {n}")
        self.n = int(n)
        self.device = device

    @property
    def axis_size(self) -> int:
        return self.n

    @property
    def ranks(self) -> Sequence[int]:
        return range(self.n)

    def all_to_all(self, payload: torch.Tensor, async_op: bool = False):
        """Tiled all-to-all of ``payload`` ``[n, n·chunk]`` (row i: rank i's
        buffer): ``[n, n, chunk]`` where ``[j]`` is owner j's ``[n, chunk]``
        stack of every rank's chunk j — a view, no copy.  ``async_op``:
        returns ``(view, None)``, nothing to wait on."""
        rows, total = payload.shape
        chunk = total // self.n
        out = _rec("all-to-all", payload, lambda: payload.view(
            rows, self.n, chunk).transpose(0, 1), rows=rows)
        return (out, None) if async_op else out

    def all_gather(self, parts: torch.Tensor) -> torch.Tensor:
        """Tiled all-gather of the owners' chunks ``[n, chunk]`` →
        ``[n·chunk]``, the same buffer."""
        return _rec("all-gather", parts, lambda: parts.reshape(-1),
                    scale=self.n, rows=parts.shape[0])

    def all_to_all_tiled(self, x: torch.Tensor, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
        """``x`` ``[n, ...]`` (row i: rank i's block) → ``[n, ...]`` where
        row j is the concatenation along ``concat_axis``, in rank order, of
        chunk j of every rank's block cut ``n`` ways along ``split_axis``
        (the axes of a rank's block).  A permute of the stack."""
        n = self.n
        a, c = split_axis + 1, concat_axis + 1

        def permute():
            y = x.unflatten(a, (n, x.shape[a] // n)).movedim(a, 0)
            return y.movedim(1, c).flatten(c, c + 1)    # y: [dst, src, ...]
        return _rec("all-to-all", x, permute, rows=x.shape[0])

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis of ``t`` ``[n, ...]`` (one row per rank)."""
        return _rec("all-reduce", t, lambda: t.sum(0), rows=t.shape[0])

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return _rec("all-reduce", t, lambda: t.amax(0), rows=t.shape[0])

    # -- the placed step's collectives: one group's blocks, as a list --

    def gather_blocks(self, xs, dim: int):
        """Every rank's ``xs[r]`` concatenated along ``dim``, one (shared)
        copy a rank; backward: the rank-order sum of the copies' gradients,
        each rank its chunk."""
        _check_group(xs, self.n)
        if _share():
            return _rec("all-gather", xs,
                        lambda: [torch.cat(xs, dim)] * self.n, scale=self.n)
        return list(_rec("all-gather", xs,
                         lambda: _StackedGather.apply(dim, *xs), scale=self.n))

    def reduce_scatter_blocks(self, xs, dim: int):
        """The rank-order sum of ``xs``, rank ``r`` its chunk ``r`` along
        ``dim``; backward: every rank the gradients gathered along ``dim``."""
        _check_group(xs, self.n)
        return list(_rec("reduce-scatter", xs,
                         lambda: _StackedReduceScatter.apply(dim, *xs)))

    def psum_blocks(self, xs, grad: str = "psum"):
        """The rank-order sum of ``xs`` on every rank; backward the sum
        (``"psum"``) or each rank's own gradient (``"identity"``)."""
        _check_group(xs, self.n)
        if _share():
            return _rec("all-reduce", xs, lambda: [_ordered_sum(xs)] * self.n)
        return list(_rec("all-reduce", xs, lambda: _StackedPsum.apply(
            grad == "identity", *xs)))

    def copy_blocks(self, xs):
        """Identity forward; backward the rank-order sum of the ranks'
        gradients on every rank."""
        _check_group(xs, self.n)
        return list(_StackedCopy.apply(*xs))

    def pmax_blocks(self, xs):
        """The elementwise max of ``xs`` on every rank, outside autograd."""
        _check_group(xs, self.n)
        with torch.no_grad():
            return _rec("all-reduce", xs, lambda: [torch.stack(
                [x.detach() for x in xs]).amax(0)] * self.n)


def _pg_stack(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``t`` stacked ``[n, ...]`` in rank order."""
    import torch.distributed as dist
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1), group=group)
    return out.view((n,) + tuple(t.shape))


def _rank_ordered(group) -> bool:
    """Does this group sum in rank order (gloo: the CPU tests hold it to
    the stacked axis bit for bit)?"""
    import torch.distributed as dist
    return dist.get_backend(group) == "gloo"


def _pg_sum(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of every rank's ``t`` (rank order on gloo)."""
    if _rank_ordered(group):
        return _ordered_sum(_pg_stack(t, group, n).unbind(0))
    import torch.distributed as dist
    s = t.contiguous().clone()
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s


def _pg_reduce_scatter(t: torch.Tensor, dim: int, group, rank: int,
                       n: int) -> torch.Tensor:
    """Chunk ``rank`` along ``dim`` of the sum of every rank's ``t``."""
    if _rank_ordered(group):
        return _pg_sum(t, group, n).chunk(n, dim)[rank].contiguous()
    import torch.distributed as dist
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


class _PGGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.dim, ctx.group, ctx.rank, ctx.n = dim, group, rank, n
        return _rec("all-gather", [x], lambda: torch.cat(
            _pg_stack(x, group, n).unbind(0), dim), scale=n)

    @staticmethod
    def backward(ctx, g):
        return (_rec("reduce-scatter", [g], lambda: _pg_reduce_scatter(
            g, ctx.dim, ctx.group, ctx.rank, ctx.n)), None, None, None, None)


class _PGReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _rec("reduce-scatter", [x], lambda: _pg_reduce_scatter(
            x, dim, group, rank, n))

    @staticmethod
    def backward(ctx, g):
        return (_rec("all-gather", [g], lambda: torch.cat(
            _pg_stack(g, ctx.group, ctx.n).unbind(0), ctx.dim), scale=ctx.n),
                None, None, None, None)


class _PGPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, identity, group, n):
        ctx.identity, ctx.group, ctx.n = identity, group, n
        return _rec("all-reduce", [x], lambda: _pg_sum(x, group, n))

    @staticmethod
    def backward(ctx, g):
        if ctx.identity:
            return g, None, None, None
        return (_rec("all-reduce", [g], lambda: _pg_sum(g, ctx.group, ctx.n)),
                None, None, None)


class _PGCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_rec("all-reduce", [g], lambda: _pg_sum(g, ctx.group, ctx.n)),
                None, None)


class ProcessGroupTransport:
    """One data-parallel rank per process, over a ``torch.distributed``
    process group (the default group when ``group`` is None)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupTransport needs "
                               "torch.distributed.init_process_group first")
        self._dist = dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    @property
    def axis_size(self) -> int:
        return self.n

    @property
    def ranks(self) -> Sequence[int]:
        return (self.rank,)

    def all_to_all(self, payload: torch.Tensor, async_op: bool = False):
        """``payload`` ``[1, n·chunk]`` → ``[1, n, chunk]``: this owner's
        stack of every rank's chunk.  ``async_op``: returns ``(out, work)``
        with the collective in flight; ``work.wait()`` before reading
        ``out``."""
        chunk = payload.shape[1] // self.n
        out = torch.empty_like(payload[0])
        work = _rec("all-to-all", payload,
                    lambda: self._dist.all_to_all_single(
                        out, payload[0].contiguous(), group=self.group,
                        async_op=async_op))
        out = out.view(1, self.n, chunk)
        return (out, work) if async_op else out

    def all_to_all_tiled(self, x: torch.Tensor, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
        """This rank's block ``[1, ...]`` → ``[1, ...]``: the concatenation
        along ``concat_axis``, in rank order, of chunk ``rank`` of every
        rank's block cut ``n`` ways along ``split_axis``."""
        n, a = self.n, split_axis
        send = x[0].unflatten(a, (n, x.shape[a + 1] // n)).movedim(a, 0)
        recv = _rec("all-to-all", [send],                        # [src, ...]
                    lambda: _AllToAll.apply(send, self.group))
        return recv.movedim(0, concat_axis).flatten(
            concat_axis, concat_axis + 1)[None]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` as ``[n, ...]``, in rank order."""
        return _rec("all-gather", [t], lambda: _GatherRows.apply(
            t, self.group, self.rank, self.n), scale=self.n)

    def all_gather(self, parts: torch.Tensor) -> torch.Tensor:
        """This owner's chunk ``[1, chunk]`` → every owner's ``[n·chunk]``."""
        out = torch.empty(self.n * parts.shape[1], dtype=parts.dtype,
                          device=parts.device)
        _rec("all-gather", parts, lambda: self._dist.
             all_gather_into_tensor(out, parts[0].contiguous(),
                                    group=self.group), scale=self.n)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        s = t.sum(0).contiguous()
        _rec("all-reduce", [s], lambda: self._dist.all_reduce(
            s, op=self._dist.ReduceOp.SUM, group=self.group))
        return s

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        s = t.amax(0).contiguous()
        _rec("all-reduce", [s], lambda: self._dist.all_reduce(
            s, op=self._dist.ReduceOp.MAX, group=self.group))
        return s

    # -- the placed step's collectives (see StackedTransport's); ``xs`` is
    # this rank's one block --

    def _one(self, xs):
        if len(xs) != 1:
            raise ValueError("a process group rank holds one block, got "
                             f"{len(xs)}")
        return xs[0]

    def gather_blocks(self, xs, dim: int):
        return [_PGGather.apply(self._one(xs), dim, self.group, self.rank,
                                self.n)]

    def reduce_scatter_blocks(self, xs, dim: int):
        return [_PGReduceScatter.apply(self._one(xs), dim, self.group,
                                       self.rank, self.n)]

    def psum_blocks(self, xs, grad: str = "psum"):
        return [_PGPsum.apply(self._one(xs), grad == "identity", self.group,
                              self.n)]

    def copy_blocks(self, xs):
        return [_PGCopy.apply(self._one(xs), self.group, self.n)]

    def pmax_blocks(self, xs):
        with torch.no_grad():
            return [self.pmax(self._one(xs).detach()[None])]
