"""Parameters of the JAX package → parameters of the port.

The two packages keep the same nested keys and the same layouts (weights are
``(in, out)``, applied as ``x @ w``; per-layer tensors are stacked on a
leading ``L`` dim), so conversion is leaf by leaf with no transposes.  The
JAX side hands its tree over as numpy arrays; bf16 leaves arrive as float32.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.common import is_def


def _convert(defs, tree, path, device, dtype):
    if is_def(defs):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not match the "
                             f"port's {defs.shape}")
        # norm scales stay fp32 whatever the working dtype, as declared
        want = defs.dtype if (dtype is None
                              or defs.dtype == torch.float32) else dtype
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=want)
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: expected a dict with keys {sorted(defs)}")
    if set(tree) != set(defs):
        raise ValueError(f"{path}: keys {sorted(tree)} do not match the "
                         f"port's {sorted(defs)}")
    return {k: _convert(defs[k], tree[k], f"{path}/{k}", device, dtype)
            for k in defs}


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """The port's parameter dict from the reference's tree of numpy arrays.

    ``np_tree`` has the reference's keys: ``embed/tok``,
    ``layers/{norm1,norm2,attn/{wq,wk,wv,wo},mlp/{w_in,w_gate,w_out}}`` with
    the stacked leading ``L``, ``final_norm``.  Shapes are checked against
    the port's own declarations for ``cfg``.  ``dtype`` overrides the
    working dtype of the weight matrices (default: what ``cfg`` declares).
    """
    from repro_torch.serve.engine import resolve_device
    defs = registry(cfg.family).model_defs(cfg)
    return _convert(defs, np_tree, "", resolve_device(device), dtype)
