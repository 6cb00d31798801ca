"""The data-parallel axis the collectives run over: counterpart of
``shard_map`` over a ``data`` mesh axis and of the ``lax`` collectives the
reference's collectives call inside it.

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
"""

from __future__ import annotations

from typing import Sequence

import torch


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
        out = payload.view(rows, self.n, chunk).transpose(0, 1)
        return (out, None) if async_op else out

    def all_gather(self, parts: torch.Tensor) -> torch.Tensor:
        """Tiled all-gather of the owners' chunks ``[n, chunk]`` →
        ``[n·chunk]``, the same buffer."""
        return parts.reshape(-1)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis of ``t`` ``[n, ...]`` (one row per rank)."""
        return t.sum(0)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return t.amax(0)


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
        work = self._dist.all_to_all_single(out, payload[0].contiguous(),
                                            group=self.group,
                                            async_op=async_op)
        out = out.view(1, self.n, chunk)
        return (out, work) if async_op else out

    def all_gather(self, parts: torch.Tensor) -> torch.Tensor:
        """This owner's chunk ``[1, chunk]`` → every owner's ``[n·chunk]``."""
        out = torch.empty(self.n * parts.shape[1], dtype=parts.dtype,
                          device=parts.device)
        self._dist.all_gather_into_tensor(out, parts[0].contiguous(),
                                          group=self.group)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        s = t.sum(0).contiguous()
        self._dist.all_reduce(s, op=self._dist.ReduceOp.SUM, group=self.group)
        return s

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        s = t.amax(0).contiguous()
        self._dist.all_reduce(s, op=self._dist.ReduceOp.MAX, group=self.group)
        return s
