"""Request queue + strict-FCFS admission for the continuous-batching loop.

Admission policy is deliberately head-of-line only: a request is admitted
iff it is the *oldest* pending request, it has arrived, a batch slot is
free, and the allocator can cover its whole lifetime
(:meth:`PagedLayout.pages_needed`) up front.  No skip-ahead means a
request's admission step — and hence its decode trajectory — never
depends on requests behind it in the queue, which keeps the
solo-equivalence property (``tests/test_torch_engine.py``) unconditional.
Reserving all pages at admission makes the loop deadlock-free: an
admitted request can always run to completion without waiting on pages
held by anyone else.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One user request: a prompt and a fixed decode budget."""

    rid: int
    prompt: np.ndarray          # int32 [prompt_len], prompt_len >= 1
    max_new: int                # tokens to return (>= 1), first from prefill
    arrival: int = 0            # engine step at which the request exists

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           np.asarray(self.prompt, np.int32).reshape(-1))
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")


def synthetic_trace(n_requests: int, vocab: int, *,
                    prompt_lens=(4, 16), new_tokens=(4, 16),
                    mean_gap: float = 0.5, seed: int = 0) -> List[Request]:
    """A many-user trace: random prompts, mixed lengths, Poisson arrivals.

    ``prompt_lens`` / ``new_tokens`` are inclusive [lo, hi] ranges;
    ``mean_gap`` is the mean inter-arrival gap in engine *steps* (0 =
    everything arrives at step 0).  Deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.poisson(mean_gap, n_requests) if mean_gap > 0 else \
        np.zeros(n_requests, np.int64)
    arrivals = np.cumsum(gaps) - gaps[0] if n_requests else gaps
    out = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        out.append(Request(
            rid=i,
            prompt=rng.integers(1, vocab, plen).astype(np.int32),
            max_new=int(rng.integers(new_tokens[0], new_tokens[1] + 1)),
            arrival=int(arrivals[i])))
    return out


class Scheduler:
    """Strict-FCFS pending queue (ordered by arrival, then rid)."""

    def __init__(self, requests: Sequence[Request]):
        self.pending = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))

    def __len__(self) -> int:
        return len(self.pending)

    def next_arrival(self) -> Optional[int]:
        return self.pending[0].arrival if self.pending else None

    def pop_admissible(self, step: int,
                       can_admit: Callable[[Request], bool]
                       ) -> Optional[Request]:
        """Head of queue, iff arrived and ``can_admit`` (slot + pages) holds."""
        if (self.pending and self.pending[0].arrival <= step
                and can_admit(self.pending[0])):
            return self.pending.popleft()
        return None

    def requeue(self, req: Request):
        """Put a popped request back at the HEAD of the queue (it stays the
        oldest pending request, so strict FCFS is preserved).  The
        backpressure path: admission popped it but the page allocator
        could not actually cover it — hold it and retry after frees
        instead of dropping it or crashing the engine."""
        self.pending.appendleft(req)
