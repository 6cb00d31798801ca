"""Paged KV-cache geometry: layout, page table, host-side allocator.

The pool holds ``n_pages`` real pages plus ONE reserved **trash page**
(physical index ``n_pages``).  Every page-table entry that does not map a
live logical page — empty slots of inactive batch rows, entries past a
request's last page — points at the trash page, so scatters and
gathers always hit a valid pool row and need no bounds branches; the
sequence-length mask keeps whatever lands there out of every output.

Physical page ids are shared across layers and across K/V (vLLM-style):
one allocation covers the token range in every layer's pool, and the
per-page precision rows for all ``2 · n_layers`` (kind, layer) views of a
page are derived from the single physical id via :func:`page_rows`.

Allocation is host-side and LIFO — page tables and lengths are plain step
*inputs* to the decode step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of one paged engine instance."""

    page_size: int           # tokens per page
    n_pages: int             # real pages in the pool (trash page excluded)
    batch_slots: int         # concurrent decode rows (B)
    max_pages_per_seq: int   # page-table width per row (P)
    max_prompt: int          # compiled prompt length (page_size multiple)

    def __post_init__(self):
        if self.max_prompt % self.page_size:
            raise ValueError(
                f"max_prompt {self.max_prompt} must be a multiple of the "
                f"page size {self.page_size}")
        if self.prompt_pages > self.max_pages_per_seq:
            raise ValueError(
                f"max_prompt spans {self.prompt_pages} pages but rows hold "
                f"only {self.max_pages_per_seq}")
        if self.n_pages < self.prompt_pages:
            raise ValueError("pool smaller than one prompt")

    @property
    def n_pages_total(self) -> int:
        return self.n_pages + 1

    @property
    def trash_page(self) -> int:
        return self.n_pages

    @property
    def prompt_pages(self) -> int:
        return self.max_prompt // self.page_size

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Pages a request occupies for its whole lifetime.

        Tokens written to the cache: the prompt plus every decode step's
        consumed token — the last generated token is returned but never
        written, hence ``max_new - 1``.
        """
        tokens = prompt_len + max(max_new - 1, 0)
        return -(-tokens // self.page_size)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        return (prompt_len <= self.max_prompt
                and self.pages_needed(prompt_len, max_new)
                <= self.max_pages_per_seq)


def page_rows(n_layers: int, n_pages_total: int, pages) -> np.ndarray:
    """Precision-domain rows for physical ``pages``: shape (2, L, len(pages)).

    Row layout of the ``kv_cache`` domain: ``((kind · L) + layer) ·
    n_pages_total + page`` with kind 0 = K, 1 = V — so a page's K rows for
    every layer are ``out[0, :, i]`` and its V rows ``out[1, :, i]``.
    """
    pages = np.asarray(pages, np.int64)
    kinds = np.arange(2)[:, None, None]
    layers = np.arange(n_layers)[None, :, None]
    return (kinds * n_layers + layers) * n_pages_total + pages[None, None, :]


class PageAllocator:
    """LIFO free-list over the real pages (the trash page is never free)."""

    def __init__(self, n_pages: int):
        self._free: List[int] = list(range(n_pages))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        # independent of the advisory can() pre-check: alloc enforces its
        # own invariant so a stale/optimistic admission decision can never
        # hand out pages the pool does not have
        if len(self._free) < n:
            raise RuntimeError(f"allocator has {len(self._free)} free pages, "
                               f"need {n}")
        out, self._free = self._free[-n:], self._free[:-n]
        return out

    def release(self, pages: Sequence[int]) -> None:
        self._free.extend(int(p) for p in pages)
