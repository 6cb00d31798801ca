"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, slice by slice.

Laid out like ``repro`` so the two can be read side by side
(``repro_torch/serve/cache.py`` is the counterpart of
``repro/serve/cache.py``).  Imports ``torch`` and numpy only.  Ported so
far: the serving path (dense decoder, paged int8 KV cache, continuous
batching) with its two hand-written Hopper kernels — the grouped wire
encoder and paged decode attention (:mod:`repro_torch.kernels`).
"""
