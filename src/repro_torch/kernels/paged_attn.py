"""Paged decode attention over an int8 KV page pool: Hopper kernel, wrapper,
plain version.

Counterpart of ``repro/kernels/paged_attn.py``.  The serving loop keeps the
KV cache as **int8 grid integers** in a paged pool — one page = one ⟨IL, FL⟩
group.  One query token per batch row attends over that row's pages: a page
is found through the page table, multiplied by its own ``2^-FL`` as it is
read, masked at the row's length and folded into an online softmax, so the
decoded fp32 cache never exists in device memory.

Page-table entries past a row's last page must point at a valid pool row
(the serve layer reserves a trash page); the length mask zeroes every
position ≥ ``lens[b]`` whatever the gathered page contains.

The kernel is ``csrc/paged_attn.cu``: split-KV, the blocks resident on the
card walking the splits of :data:`SPLIT_TOKENS` tokens of every (row, KV
head), then a merge of a row's splits in a fixed order.  :func:`paged_decode_attn` launches it for CUDA
tensors and runs :func:`paged_decode_attn_plain` for CPU tensors, and never
the one in place of the other.  ``paged_decode_attn_plain(...,
split_tokens=n)`` is the kernel's arithmetic in plain PyTorch: each split's
(m, l, acc) and their merge.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fixed_point import exp2_int
from repro_torch.kernels import _build

# finite, so masked-row softmax math stays NaN-free (exp(NEG_INF - m)
# underflows to exactly 0.0)
NEG_INF = -1e30

# calls of the CUDA kernel by the wrapper (a call is two launches: split
# and merge)
launch_count = 0

# Tokens a split covers (rounded down to whole pages, at least one page).
# Chosen on an H100 80GB HBM3 at 700 W by kernel_ab.py, K5's median time
# replayed from a CUDA graph at 32 / 64 / 128 tokens: serving shape (8 rows,
# at most 577 tokens) 0.0194 / 0.0183 / 0.0182 ms; 8 rows of 4,096 tokens
# 0.0787 / 0.0610 / 0.0568 ms.
SPLIT_TOKENS = 128
# shared memory a split block may give its two stage buffers of K and V; a
# wide fp32 pool gets fewer tokens a split
SPLIT_STAGE_BYTES = 96 * 1024


def _check(q, k_pages, v_pages, fmt, ptab, lens):
    if q.dtype != torch.float32 or q.ndim != 3:
        raise TypeError("q must be float32 (B, H, Dh)")
    B, H, Dh = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must share one (n_pages, page, KV, "
                         "Dh) shape")
    if k_pages.dtype not in (torch.int8, torch.float32) \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError("page pools must both be int8 or both float32")
    n_pages, ps, KV, Dh_k = k_pages.shape
    if Dh_k != Dh or KV < 1 or H % KV:
        raise ValueError(f"q heads ({H}, {Dh}) do not group over pool heads "
                         f"({KV}, {Dh_k})")
    if fmt.dtype != torch.int32 or tuple(fmt.shape) != (n_pages, 2):
        raise TypeError(f"fmt must be int32 ({n_pages}, 2)")
    if ptab.dtype != torch.int32 or ptab.ndim != 2 or ptab.shape[0] != B:
        raise TypeError(f"ptab must be int32 ({B}, P)")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise TypeError(f"lens must be int32 ({B},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("fmt", fmt), ("ptab", ptab), ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, H, Dh, n_pages, ps, KV, ptab.shape[1]


def split_plan(P: int, ps: int, B: int, KV: int, G: int, Dh: int,
               esize: int = 1, split_tokens: int = SPLIT_TOKENS):
    """The kernel's split geometry for a (B, P) page table of ``ps``-token
    pages whose K/V elements take ``esize`` bytes: ``(pages per split,
    S_max splits a row, workspace shape)``.  A split covers ``split_tokens``
    tokens (the wrapper's :data:`SPLIT_TOKENS`), fewer where two stage
    buffers of its K and V would pass :data:`SPLIT_STAGE_BYTES`, and whole
    pages, at least one.
    The workspace holds each split's ``acc[G, Dh]``, ``m[G]`` and ``l[G]``:
    ``(B, KV, S_max, G * (Dh + 2))`` fp32."""
    if min(P, ps, B, KV, G, Dh, esize, split_tokens) < 1:
        raise ValueError("split_plan needs positive sizes")
    fit = SPLIT_STAGE_BYTES // (4 * Dh * esize)
    sp = max(1, min(split_tokens, fit) // ps)
    s_max = -(-P // sp)
    return sp, s_max, (B, KV, s_max, G * (Dh + 2))


def paged_decode_attn_plain(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, fmt: torch.Tensor,
                            ptab: torch.Tensor, lens: torch.Tensor,
                            *, scale: float,
                            split_tokens: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  Without ``split_tokens``:
    page slot by page slot over the whole table, all batch rows at once, one
    page decoded per step, an online softmax.  With it: the kernel's
    arithmetic — the table cut into splits of ``split_tokens // ps`` pages
    (at least one), each split's (m, l, acc) over its live tokens, and the
    row's used splits merged in split order (the kernel adds the same terms
    in quarters of the splits, then the quarters in order)."""
    B, H, Dh, _, ps, KV, P = _check(q, k_pages, v_pages, fmt, ptab, lens)
    if split_tokens is not None:
        return _split_plain(q, k_pages, v_pages, fmt, ptab, lens, scale,
                            max(1, split_tokens // ps))
    G = H // KV
    f32 = dict(dtype=torch.float32, device=q.device)
    qg = q.reshape(B, KV, G, Dh)
    m = torch.full((B, KV, G, 1), NEG_INF, **f32)
    l = torch.zeros((B, KV, G, 1), **f32)
    acc = torch.zeros((B, KV, G, Dh), **f32)
    offs = torch.arange(ps, device=q.device, dtype=torch.int32)
    for p in range(P):
        phys = ptab[:, p].to(torch.int64)                    # (B,)
        unit = exp2_int(-fmt[phys])                          # (B, 2) 2^-FL
        k = k_pages[phys].to(torch.float32) * unit[:, 0].reshape(B, 1, 1, 1)
        v = v_pages[phys].to(torch.float32) * unit[:, 1].reshape(B, 1, 1, 1)
        # scores (B, KV, G, ps): query head h = kv·G + g reads KV head kv
        s = torch.einsum("bkgd,bjkd->bkgj", qg, k)
        valid = ((p * ps + offs)[None, :] < lens[:, None]).to(torch.float32)
        valid = valid.reshape(B, 1, 1, ps)
        s = s * scale + torch.where(valid > 0.0, 0.0, NEG_INF)
        new_m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # the multiply by `valid` matters: on a fully masked page s - new_m
        # is 0 and exp gives 1 per position
        pr = torch.exp(s - new_m) * valid
        corr = torch.exp(m - new_m)
        l = l * corr + pr.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgj,bjkd->bkgd", pr, v)
        m = new_m
    # fully masked rows (inactive batch slots) have l == 0 → 0, not NaN
    return (acc / l.clamp(min=1e-30)).reshape(B, H, Dh)


def _split_plain(q, k_pages, v_pages, fmt, ptab, lens, scale, sp):
    B, H, Dh = q.shape
    _, ps, KV, _ = k_pages.shape
    P = ptab.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, Dh)
    n = lens.to(torch.int64).clamp(0, P * ps)
    ms, ls, accs = [], [], []
    for p0 in range(0, P, sp):
        pages = range(p0, min(P, p0 + sp))
        # the split's scores (B, KV, G, T) and its masked positions
        s = torch.cat([_page_scores(qg, k_pages, fmt, ptab[:, p], scale)
                       for p in pages], dim=-1)
        pos = p0 * ps + torch.arange(s.shape[-1], device=q.device)
        valid = (pos[None, :] < n[:, None]).reshape(B, 1, 1, -1)
        m = torch.where(valid, s, NEG_INF).amax(dim=-1, keepdim=True)
        pr = torch.where(valid, torch.exp(s - m), 0.0)
        # the values: p·2^-FL_v of each token's page (exact) against the
        # integer values; positions past the length are never read
        unit_v = torch.cat([exp2_int(-fmt[ptab[:, p].to(torch.int64)][:, 1])
                            [:, None].expand(B, ps) for p in pages], dim=1)
        v = torch.cat([v_pages[ptab[:, p].to(torch.int64)].to(torch.float32)
                       for p in pages], dim=1)
        v = torch.where(valid.reshape(B, -1, 1, 1), v, 0.0)
        acc = torch.einsum("bkgj,bjkd->bkgd", pr * unit_v.reshape(B, 1, 1, -1),
                           v)
        used = (p0 * ps < n).reshape(B, 1, 1, 1)   # a split the kernel runs
        ms.append(torch.where(used, m, NEG_INF))
        ls.append(torch.where(used, pr.sum(dim=-1, keepdim=True), 0.0))
        accs.append(torch.where(used, acc, 0.0))
    # the merge, in split order; unused splits add exactly 0
    m = torch.stack(ms).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Dh), dtype=torch.float32, device=q.device)
    for m_s, l_s, a_s in zip(ms, ls, accs):
        w = torch.exp(m_s - m)
        l = l + l_s * w
        acc = acc + a_s * w
    # a row of length 0 has l == 0 and acc == 0: exactly 0, not NaN
    return (acc / l.clamp(min=1e-30)).reshape(B, H, Dh)


def _page_scores(qg, k_pages, fmt, phys, scale):
    """Scores (B, KV, G, ps) of one page slot: q against the page's int8 keys,
    times 2^-FL_k and ``scale``."""
    phys = phys.to(torch.int64)
    unit = exp2_int(-fmt[phys][:, 0]).reshape(-1, 1, 1, 1)
    k = k_pages[phys].to(torch.float32)
    return torch.einsum("bkgd,bjkd->bkgj", qg, k) * unit * scale


def _paged_decode_attn_cuda(q, k_pages, v_pages, fmt, ptab, lens, *, scale):
    global launch_count
    B, H, Dh, _, ps, KV, P = _check(q, k_pages, v_pages, fmt, ptab, lens)
    for name, t, a in (("q", q, 16), ("k_pages", k_pages, 16),
                       ("v_pages", v_pages, 16), ("fmt", fmt, 8)):
        if t.data_ptr() % a:
            raise ValueError(f"{name} must be {a}-byte aligned")
    lib = _build.load()
    sp, _, ws_shape = split_plan(P, ps, B, KV, H // KV, Dh,
                                 k_pages.element_size())
    out = torch.empty_like(q)
    ws = torch.empty(ws_shape, dtype=torch.float32, device=q.device)
    # the launches are asynchronous; PyTorch's allocator hands freed memory
    # only to later work on the same stream, so the kernel's buffers outlive
    # them
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_decode_attn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            int(k_pages.dtype == torch.int8), fmt.data_ptr(), ptab.data_ptr(),
            lens.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, KV, Dh, ps,
            P, sp, float(scale), stream)
    _build.check(lib, code, "paged_decode_attn")
    launch_count += 1
    return out


def paged_decode_attn(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, fmt: torch.Tensor,
                      ptab: torch.Tensor, lens: torch.Tensor,
                      *, scale: float, backend: str = "auto") -> torch.Tensor:
    """One-token decode attention through a page table; on a CUDA tensor one
    call is two launches (the splits, then their merge).

    ``q``: fp32 (B, H, Dh) single-token queries.  ``k_pages``/``v_pages``:
    (n_pages, page, KV, Dh) int8 pools (fp32 when paging runs without
    quantization; then FL = 0 and the decode multiply is an exact ×1.0).
    ``fmt``: int32 (n_pages, 2) per-page [FL_k, FL_v].  ``ptab``: int32
    (B, P) logical→physical page table.  ``lens``: int32 (B) valid lengths;
    a row of length 0 comes out exactly 0.  Returns fp32 (B, H, Dh), within
    1e-5 of the plain version (the order of the sums differs).

    ``backend``: ``"auto"`` launches the CUDA kernel for a CUDA tensor and
    runs the plain version for a CPU tensor; ``"kernel"`` raises for a CPU
    tensor; ``"plain"`` runs the plain version wherever the tensor lies.
    """
    if backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown paged-attention backend {backend!r}")
    if backend == "plain" or (backend == "auto" and not q.is_cuda):
        return paged_decode_attn_plain(q, k_pages, v_pages, fmt, ptab, lens,
                                       scale=scale)
    if not q.is_cuda:
        raise ValueError("backend='kernel' needs a CUDA tensor: paged decode "
                         "attention is a CUDA kernel")
    return _paged_decode_attn_cuda(q, k_pages, v_pages, fmt, ptab, lens,
                                   scale=scale)
