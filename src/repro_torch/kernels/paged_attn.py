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

The kernel is ``csrc/paged_attn.cu``.  :func:`paged_decode_attn` launches it
for CUDA tensors and runs :func:`paged_decode_attn_plain` for CPU tensors,
and never the one in place of the other.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import exp2_int
from repro_torch.kernels import _build

# finite, so masked-row softmax math stays NaN-free (exp(NEG_INF - m)
# underflows to exactly 0.0)
NEG_INF = -1e30

# launches of the CUDA kernel by the wrapper
launch_count = 0


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


def paged_decode_attn_plain(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, fmt: torch.Tensor,
                            ptab: torch.Tensor, lens: torch.Tensor,
                            *, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: page slot by page slot over
    the whole table, all batch rows at once, one page decoded per step."""
    B, H, Dh, _, ps, KV, P = _check(q, k_pages, v_pages, fmt, ptab, lens)
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


def _paged_decode_attn_cuda(q, k_pages, v_pages, fmt, ptab, lens, *, scale):
    global launch_count
    B, H, Dh, _, ps, KV, P = _check(q, k_pages, v_pages, fmt, ptab, lens)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load()
    out = torch.empty_like(q)
    # the launch is asynchronous; PyTorch's allocator hands freed memory only
    # to later work on the same stream, so the kernel's buffers outlive it
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.paged_decode_attn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            int(k_pages.dtype == torch.int8), fmt.data_ptr(), ptab.data_ptr(),
            lens.data_ptr(), out.data_ptr(), B, H, KV, Dh, ps, P,
            float(scale), stream)
    _build.check(lib, code, "paged_decode_attn")
    launch_count += 1
    return out


def paged_decode_attn(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, fmt: torch.Tensor,
                      ptab: torch.Tensor, lens: torch.Tensor,
                      *, scale: float, backend: str = "auto") -> torch.Tensor:
    """One-token decode attention through a page table; one launch per call.

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
