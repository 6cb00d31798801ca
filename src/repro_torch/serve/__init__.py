"""repro_torch.serve — continuous-batching LM inference on a paged int8 KV
cache.

The serving-side consumer of the DPS machinery: pages are int8 grid integers
under per-page ⟨IL, FL⟩ formats owned by the ``kv_cache`` precision domain,
encoded by the grouped wire codec and dequantized as they are read by the
paged decode-attention kernel (:mod:`repro_torch.kernels.paged_attn`).
"""

from repro_torch.serve.cache import (DEFAULT_IL_INIT, KV_DOMAIN, PagedKV,
                                     fmt_tables, init_pool, kv_plan,
                                     write_prompt_pages)
from repro_torch.serve.engine import (Engine, EngineConfig, ServeReport,
                                      analysis_decode, supports_paging)
from repro_torch.serve.page_table import PageAllocator, PagedLayout, page_rows
from repro_torch.serve.scheduler import Request, Scheduler, synthetic_trace

__all__ = [
    "DEFAULT_IL_INIT", "KV_DOMAIN", "PagedKV", "fmt_tables", "init_pool",
    "kv_plan", "write_prompt_pages", "Engine", "EngineConfig",
    "ServeReport", "analysis_decode", "supports_paging", "PageAllocator", "PagedLayout",
    "page_rows", "Request", "Scheduler", "synthetic_trace",
]
