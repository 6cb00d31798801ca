"""Continuous-batching inference engine over the paged DPS KV cache.

Counterpart of ``repro/serve/engine.py``.  Prefill/decode split: each
admission runs the prompt once at batch 1 at the layout's fixed
``max_prompt``, encodes the resulting contiguous cache into int8 pages
(``cache.write_prompt_pages``), and drops the request into a free decode
row.  Decode is one jointly-batched step over all ``batch_slots`` rows —
inactive rows ride along pointed at the trash page — so admissions and
retirements only rewrite *inputs* (page table, positions, last tokens).

Everything runs eagerly; the pools are updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.common import TOK_F32, unembed
from repro_torch.serve import cache as kvc
from repro_torch.serve.page_table import PageAllocator, PagedLayout, page_rows
from repro_torch.serve.scheduler import Request, Scheduler

BACKENDS = ("auto", "kernel", "plain")


def supports_paging(cfg: ModelConfig) -> bool:
    """Paged serving needs the GQA decode path; of the families that have
    one, only the dense decoder is ported."""
    return cfg.family == "dense" and not cfg.mla


def resolve_device(device) -> torch.device:
    """An entry point's ``device`` argument as a ``torch.device``; asking for
    CUDA on a machine without it raises rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    layout: PagedLayout
    kv_bits: Optional[int] = 8     # 8 = int8 DPS pages; None = fp32 pages
    attn_backend: str = "auto"     # paged decode attention: kernel | plain
    encode_backend: str = "auto"   # page codec: kernel | plain
    il_init: int = kvc.DEFAULT_IL_INIT
    max_concurrency: Optional[int] = None  # 1 = serial-serving baseline


@dataclasses.dataclass
class ServeReport:
    tokens: Dict[int, List[int]]   # rid -> generated token ids (greedy)
    metrics: Dict[str, float]
    format_spread: Dict[str, int]  # "<il,fl>" -> live prompt pages placed


class Engine:
    """Holds the model and the step functions; :meth:`run` drives a trace.

    ``params`` must lie on ``device``.  ``"auto"`` backends resolve to the
    CUDA kernels on a CUDA device and to their plain versions on the CPU;
    ``"kernel"`` on the CPU raises.
    """

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device="cuda"):
        if not supports_paging(cfg):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} (mla="
                             f"{cfg.mla}) has no paged decode path")
        if ecfg.kv_bits not in (None, 8):
            raise ValueError(f"kv_bits must be 8 or None, got {ecfg.kv_bits}")
        # the engine owns KV quantization at page granularity; the model's
        # own contiguous int8-cache mode must not double-quantize prefill
        if cfg.kv_cache_bits == 8:
            cfg = dataclasses.replace(cfg, kv_cache_bits=16)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.layout = ecfg.layout
        self.bits = ecfg.kv_bits
        self.mod = registry(cfg.family)

        on_card = self.device.type == "cuda"
        for name, b in (("attn_backend", ecfg.attn_backend),
                        ("encode_backend", ecfg.encode_backend)):
            if b not in BACKENDS:
                raise ValueError(f"{name} must be one of {BACKENDS}, got {b!r}")
            if b == "kernel" and not on_card:
                raise ValueError(f"{name}='kernel' needs a CUDA device, "
                                 f"engine is on {self.device}")
        pick = lambda b: b if b != "auto" else ("kernel" if on_card else "plain")
        self._attn_backend = pick(ecfg.attn_backend)
        self._enc_backend = pick(ecfg.encode_backend)

        # the logits are an fp32 product against the fp32 cast of the tied
        # embedding table: hold that cast once instead of making it per step
        embed = params["embed"]
        if ("unembed" not in embed and TOK_F32 not in embed
                and embed["tok"].dtype != torch.float32):
            embed = dict(embed, **{TOK_F32: embed["tok"].to(torch.float32)})
            params = dict(params, embed=embed)
        self.params = params

        self.plan = (kvc.kv_plan(cfg, self.layout, ecfg.il_init)
                     if self.bits == 8 else None)

    # ------------------------------------------------------------------
    # the three step functions
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, plen: int):
        """Prompt forward at the fixed ``max_prompt``; the logits are taken
        at position ``plen - 1``, not at the padded last position."""
        hidden, cache2 = self.mod.forward(
            self.cfg, self.params, tokens, mode="prefill", hidden_only=True)
        last = hidden[:, plen - 1:plen]
        logits = unembed(last, self.params["embed"], self.cfg.vocab)
        return logits[0, -1].to(torch.float32), cache2[0], cache2[1]

    @torch.no_grad()
    def encode(self, pools, state, ck, cv, phys, plen: int):
        return kvc.write_prompt_pages(
            self.cfg, self.layout, self.plan, pools, state, ck, cv, phys,
            plen, bits=self.bits, encode_backend=self._enc_backend)

    @torch.no_grad()
    def decode(self, tokens, pools, state, ptab, pos):
        """One batched decode step.

        ``state`` is the kv_cache FlexState at ``kv_bits=8`` and ``None``
        at ``kv_bits=None`` (fp32 pages, zero-FL tables → ×1.0 dequant).
        """
        if self.bits == 8:
            k_fmt, v_fmt = kvc.fmt_tables(state, self.cfg, self.layout)
        else:
            k_fmt, v_fmt = kvc.zero_fmt_tables(self.cfg, self.layout,
                                               self.device)
        cache = (pools.k_pages, pools.v_pages, k_fmt, v_fmt)
        logits, new_cache = self.mod.decode_step_paged(
            self.cfg, self.params, tokens, cache, ptab, pos,
            backend=self._attn_backend)
        return (logits.to(torch.float32),
                kvc.PagedKV(new_cache[0], new_cache[1]))

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------

    def run(self, requests: Sequence[Request], *,
            max_steps: Optional[int] = None) -> ServeReport:
        lay, B = self.layout, self.layout.batch_slots
        for r in requests:
            need = lay.pages_needed(r.prompt.size, r.max_new)
            if not lay.fits(r.prompt.size, r.max_new) or need > lay.n_pages:
                raise ValueError(
                    f"request {r.rid} (prompt {r.prompt.size}, max_new "
                    f"{r.max_new} -> {need} pages) can never fit layout "
                    f"{lay}")

        sched = Scheduler(requests)
        alloc = PageAllocator(lay.n_pages)
        pools = kvc.init_pool(self.cfg, lay, self.bits, self.device)
        state = (self.plan.init(self.device)[kvc.KV_DOMAIN]
                 if self.bits == 8 else None)

        ptab = np.full((B, lay.max_pages_per_seq), lay.trash_page, np.int32)
        pos = np.zeros(B, np.int32)
        last = np.zeros(B, np.int32)
        slots: List[Optional[dict]] = [None] * B
        tokens_out: Dict[int, List[int]] = {r.rid: [] for r in requests}
        lat: List[float] = []
        step_s: List[float] = []
        prefill_s: List[float] = []
        occ: List[int] = []
        spread: Counter = Counter()
        cap = min(self.ecfg.max_concurrency or B, B)
        guard = max_steps if max_steps is not None else (
            sum(r.max_new for r in requests)
            + max((r.arrival for r in requests), default=0)
            + len(requests) + 16)

        L, n_tot = self.cfg.n_layers, lay.n_pages_total
        step = 0
        bp_steps = 0   # steps an arrived request was held for page frees
        t0 = time.perf_counter()
        while sched.pending or any(s is not None for s in slots):
            if step > guard:
                raise RuntimeError(f"serving loop exceeded {guard} steps")

            # retire finished rows: free pages, clear precision history
            for b, s in enumerate(slots):
                if s is not None and s["produced"] >= s["req"].max_new:
                    alloc.release(s["pages"])
                    if self.bits == 8:
                        rows = page_rows(L, n_tot, s["pages"]).reshape(-1)
                        mask = np.zeros(kvc.n_rows(self.cfg, lay), bool)
                        mask[rows] = True
                        state = kvc.reset_rows(
                            self.plan, state,
                            torch.from_numpy(mask).to(self.device))
                    ptab[b] = lay.trash_page
                    pos[b] = 0
                    last[b] = 0
                    slots[b] = None

            # admit (strict FCFS) while a slot is free and pages cover the
            # head request's whole lifetime
            while sum(s is not None for s in slots) < cap:
                req = sched.pop_admissible(
                    step, lambda r: alloc.can(
                        lay.pages_needed(r.prompt.size, r.max_new)))
                if req is None:
                    # head arrived but can't start -> pool backpressure:
                    # the request waits in the queue for frees, it is
                    # never dropped
                    if (sched.pending
                            and sched.pending[0].arrival <= step):
                        bp_steps += 1
                    break
                b = next(i for i, s in enumerate(slots) if s is None)
                try:
                    pages = alloc.alloc(
                        lay.pages_needed(req.prompt.size, req.max_new))
                except RuntimeError:
                    # allocator exhaustion despite the can() pre-check
                    # (accounting drift): hold the request at the queue
                    # head and retry after the next retire frees pages —
                    # backpressure, not a crash
                    sched.requeue(req)
                    bp_steps += 1
                    break
                pools, state = self._admit(
                    b, req, pages, pools, state, ptab, pos, last, slots,
                    tokens_out, prefill_s, spread)

            act = [b for b, s in enumerate(slots) if s is not None]
            if act:
                occ.append(len(act))
                t_d = time.perf_counter()
                logits, pools = self._decode_call(pools, state, ptab, pos,
                                                  last)
                # the copy to the host waits for the step to finish
                nxt = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
                dt = time.perf_counter() - t_d
                step_s.append(dt)
                for b in act:
                    s = slots[b]
                    tokens_out[s["req"].rid].append(int(nxt[b]))
                    s["produced"] += 1
                    pos[b] += 1
                    last[b] = nxt[b]
                    lat.append(dt)
            elif sched.pending:
                nxt_arr = sched.next_arrival()
                if nxt_arr is not None and nxt_arr > step + 1:
                    step = nxt_arr - 1          # fast-forward idle gaps
            step += 1

        wall = time.perf_counter() - t0
        total = sum(len(v) for v in tokens_out.values())
        pct = lambda xs, q: float(np.percentile(xs, q) * 1e3) if xs else 0.0
        metrics = {
            "wall_s": wall,
            "total_tokens": float(total),
            "tokens_per_s": total / wall if wall > 0 else 0.0,
            "decode_steps": float(len(occ)),
            "decoded_tokens": float(len(lat)),
            "p50_ms_per_token": pct(lat, 50),
            "p95_ms_per_token": pct(lat, 95),
            "p50_ms_per_step": pct(step_s, 50),
            "p95_ms_per_step": pct(step_s, 95),
            "mean_occupancy": float(np.mean(occ)) if occ else 0.0,
            "admissions": float(len(prefill_s)),
            "prefill_s_total": float(np.sum(prefill_s)) if prefill_s else 0.0,
            "backpressure_steps": float(bp_steps),
        }
        return ServeReport(tokens_out, metrics, dict(spread))

    def _admit(self, b, req, pages, pools, state, ptab, pos, last, slots,
               tokens_out, prefill_s, spread):
        lay = self.layout
        plen = int(req.prompt.size)
        need = len(pages)

        t_a = time.perf_counter()
        toks = np.zeros(lay.max_prompt, np.int32)
        toks[:plen] = req.prompt
        logits, ck, cv = self.prefill(
            torch.from_numpy(toks).to(self.device)[None], plen)
        phys = np.full(lay.prompt_pages, lay.trash_page, np.int32)
        npp = min(need, lay.prompt_pages)
        phys[:npp] = pages[:npp]
        pools, state = self.encode(pools, state, ck, cv,
                                   torch.from_numpy(phys).to(self.device),
                                   plen)
        first = int(logits.argmax())
        prefill_s.append(time.perf_counter() - t_a)

        row = np.full(lay.max_pages_per_seq, lay.trash_page, np.int32)
        row[:need] = pages
        ptab[b] = row
        pos[b] = plen
        last[b] = first
        slots[b] = {"req": req, "pages": pages, "produced": 1}
        tokens_out[req.rid].append(first)

        if self.bits == 8:
            # a host read per admission; it only feeds the report
            live = -(-plen // lay.page_size)
            rows = page_rows(self.cfg.n_layers, lay.n_pages_total,
                             pages[:live]).reshape(-1)
            il = state.il.cpu().numpy()[rows]
            fl = state.fl.cpu().numpy()[rows]
            spread.update(f"<{int(a)},{int(f)}>" for a, f in zip(il, fl))
        return pools, state

    def _decode_call(self, pools, state, ptab, pos, last):
        dev = self.device
        return self.decode(torch.from_numpy(last[:, None].copy()).to(dev),
                           pools, state,
                           torch.from_numpy(ptab.copy()).to(dev),
                           torch.from_numpy(pos.copy()).to(dev))
