"""Deterministic synthetic token stream (counterpart of
``repro/data/synthetic.py``; the numpy generator is the reference's, so
both packages see the same tokens for the same ``(seed, step)``).

Sequences follow a learnable affine-recurrence pattern over the vocab
(`tok_{t+1} = (a·tok_t + c) mod V` with per-sequence (a, c) and flip noise),
so training loss actually falls.  The stream is a pure function of
``(seed, step)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05     # fraction of positions replaced with uniform noise


class TokenStream:
    """``batch(step) -> {"tokens": (B, S+1) int32 tensor on device}`` —
    stateless.  ``extras``: tensors every batch carries beside the tokens
    (a VLM's ``vision_embeds``, say)."""

    def __init__(self, cfg: TokenStreamConfig, device="cpu", extras=None):
        self.cfg = cfg
        self.device = device
        self.extras = dict(extras or {})

    def batch_np(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31))
        B, S, V = cfg.global_batch, cfg.seq_len + 1, cfg.vocab
        a = rng.randint(1, 8, size=(B, 1)).astype(np.int64)
        c = rng.randint(0, V, size=(B, 1)).astype(np.int64)
        t0 = rng.randint(0, V, size=(B, 1)).astype(np.int64)
        toks = np.empty((B, S), np.int64)
        toks[:, :1] = t0
        for t in range(1, S):
            toks[:, t:t + 1] = (a * toks[:, t - 1:t] + c) % V
        flip = rng.rand(B, S) < cfg.noise
        toks[flip] = rng.randint(0, V, size=int(flip.sum()))
        return toks.astype(np.int32)

    def batch(self, step: int):
        return {"tokens": torch.from_numpy(self.batch_np(step)).to(self.device),
                **self.extras}

    # checkpointable cursor: the step number itself
    def state(self, step: int) -> dict:
        return {"cursor": step, "seed": self.cfg.seed}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["cursor"])
