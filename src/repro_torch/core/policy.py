"""Quantization policy: which tensors the DPS quantizers touch.

The paper quantizes weights, biases, activations and gradients (Alg. 1).
At LM scale a handful of numerically sensitive islands must stay in float —
each is the same kind of carve-out the paper itself makes for gradients
("requires the most precision in order for training to converge"):

  * norm scales / biases        — O(d) params, scale-sensitive
  * router weights & logits     — quantizing routing probabilities reorders
                                  top-k and destabilizes expert assignment
  * SSM recurrent islands       — A_log, dt_bias, and the recurrent state:
                                  fixed-point state underflows at 2^-FL over
                                  4k-512k step recurrences (paper §5 predicts
                                  exactly this failure: smallest value 2^-FL)
  * RoPE tables / positions     — deterministic constants

Everything else — projections, embeddings, MoE expert weights, conv stems —
is quantized.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

DEFAULT_EXCLUDE: tuple = (
    r"norm", r"ln_", r"_scale$", r"router", r"gate_w$", r"a_log", r"dt_bias",
    r"rope", r"pos_emb",
)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Name-pattern based tensor selection (static; hashable)."""

    quantize_weights: bool = True
    quantize_acts: bool = True
    quantize_grads: bool = True
    exclude: Sequence[str] = DEFAULT_EXCLUDE

    def quantizes(self, domain: str) -> bool:
        """Does the policy quantize this precision domain's tensors?

        The three compute domains map onto their enable flags.  Wire domains
        are always true: the int8 wire is a transport codec whose engagement
        is decided by ``QuantConfig.grad_allreduce_bits`` (and, for the flat
        ZeRO params leg, by the per-leaf carve-outs via
        ``param_predicate``) — not by the numerics policy.
        """
        return {"weights": self.quantize_weights,
                "acts": self.quantize_acts,
                "grads": self.quantize_grads}.get(domain, True)

    def param_predicate(self):
        pats = [re.compile(p) for p in self.exclude]

        def pred(path, leaf) -> bool:
            if not self.quantize_weights:
                return False
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            return not any(p.search(name) for p in pats)

        return pred
