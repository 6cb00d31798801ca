"""Parameters of the JAX package → parameters of the port (and ZeRO-1
optimizer state both ways).

The two packages keep the same nested keys and the same layouts (weights are
``(in, out)``, applied as ``x @ w``; per-layer tensors are stacked on a
leading ``L`` dim), so conversion is leaf by leaf with no transposes — except
LeNet's convolution kernels, which the reference keeps HWIO and the port
OIHW.  The JAX side hands its tree over as numpy arrays; bf16 leaves arrive
as float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.common import is_def


def _convert(defs, tree, path, device, dtype):
    if is_def(defs):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not match the "
                             f"port's {defs.shape}")
        # norm scales and the router stay fp32 whatever the working dtype,
        # as declared; a copy, so that training in place on the CPU leaves
        # the caller's arrays alone
        want = defs.dtype if (dtype is None
                              or defs.dtype == torch.float32) else dtype
        return torch.from_numpy(np.array(arr)).to(device=device, dtype=want)
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: expected a dict with keys {sorted(defs)}")
    if set(tree) != set(defs):
        raise ValueError(f"{path}: keys {sorted(tree)} do not match the "
                         f"port's {sorted(defs)}")
    return {k: _convert(defs[k], tree[k], f"{path}/{k}", device, dtype)
            for k in defs}


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device="cuda",
                    dtype: Optional[torch.dtype] = None, *,
                    training: bool = False):
    """The port's parameter dict from the reference's tree of numpy arrays.

    ``np_tree`` has the reference's keys: ``embed/{tok[,unembed]}``,
    ``layers/{norm1,norm2,attn/{wq,wk,wv,wo}`` (MLA: ``attn/{wq_a,q_norm,
    wq_b,wkv_a,kv_norm,w_uk,w_uv,wo}``, ``w_uk``/``w_uv`` (L, kvr, H, d))
    and either ``mlp/{w_in,w_gate,w_out}`` or (MoE) ``moe/{router,w_in,
    w_gate,w_out[,shared/{w_in,w_gate,w_out}]}}`` with the stacked leading
    ``L`` (the experts' leaves 4-D, ``(L, E, in, out)``), ``final_norm``.
    Shapes are checked against the port's own declarations for ``cfg``.
    ``dtype`` overrides the working dtype of the weight matrices (default:
    what ``cfg`` declares — the compute dtype, or with ``training`` the
    trainer's master dtype ``cfg.param_dtype``); the leaves declared fp32
    whatever the working dtype (norm scales, the MoE router) stay fp32.
    """
    defs = registry(cfg.family).model_defs(
        cfg, cfg.master_dtype() if training else None)
    return _convert(defs, np_tree, "", resolve_device(device), dtype)


def lenet_params_from_jax(np_tree: Mapping[str, Any], device="cuda"):
    """LeNet's fp32 parameters from the reference's tree of numpy arrays:
    the same keys, the conv kernels transposed from HWIO to OIHW."""
    from repro_torch.models import lenet
    tree = {k: (np.transpose(np.asarray(v), (3, 2, 0, 1))
                if k in lenet.CONV_KEYS else v) for k, v in np_tree.items()}
    return _convert(lenet.model_defs(), tree, "", resolve_device(device), None)


def _reference_quantum(size: int, groups: int, backend: str) -> int:
    """The reference's default grouped-wire quantum (its
    ``collectives.default_wire_quantum``): ``ceil(size / G)`` rounded up to
    the backend's tile — 128 for its jnp codec, 4096 for its TPU kernel —
    capped at 4096."""
    tile = 4096 if backend == "kernel" else 128
    target = -(-max(size, 1) // max(groups, 1))
    return min(4096, max(tile, -(-target // tile) * tile))


def _reference_partitioner(qcfg, params, n_shards: int, backend: str):
    """The flat ZeRO layout the reference's ``zero_partitioner`` builds for
    this config: the port's partitioners with the reference's quanta."""
    import math

    from repro_torch.core import qtrain
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import GroupAlignedPartitioner
    part = qtrain.zero_partitioner(qcfg, params, n_shards)
    if not isinstance(part, GroupAlignedPartitioner):
        return part
    sizes = [math.prod(s) or 1 for s in part.shapes]
    layouts = []
    for run in part.buckets:
        b_sizes = tuple(sizes[i] for i in run)
        layouts.append(collectives.group_layout(
            b_sizes, n_chunks=n_shards,
            quantum=_reference_quantum(sum(b_sizes), len(run), backend)))
    return dataclasses.replace(part, layouts=tuple(layouts))


def zero_opt_state_from_jax(np_state: Mapping[str, Any], params, qcfg,
                            transport, *, reference_backend: str = "jnp"):
    """The port's ZeRO-1 optimizer state from the reference's.

    ``np_state``: the reference's ``zero_opt_state`` as numpy arrays (one
    flat ``[padded_size]`` vector per state tensor, rank-major shards of
    its layout).  Each is unflattened with the reference's geometry
    (``zero_partitioner`` of ``qcfg`` with the quanta the reference's
    ``reference_backend`` codec resolves: ``"jnp"`` on CPU, ``"kernel"``
    on TPU) and flattened with the port's; returns one ``[shard_size]``
    row per rank ``transport`` holds, as
    :func:`repro_torch.core.qtrain.zero_opt_state` makes them.
    ``params``: the port's parameter tree (for its shapes and device).
    """
    from repro_torch.core import qtrain
    from repro_torch.core import tree as tree_lib
    n = transport.axis_size
    ref = _reference_partitioner(qcfg, params, n, reference_backend)
    part = qtrain.zero_partitioner(qcfg, params, n)
    device = tree_lib.leaves(params)[0].device
    out = {}
    for name, arr in np_state.items():
        arr = np.asarray(arr, np.float32)
        if arr.shape != (ref.padded_size,):
            raise ValueError(f"{name}: shape {arr.shape}, the reference's "
                             f"layout holds ({ref.padded_size},)")
        shards = torch.from_numpy(arr).reshape(n, ref.shard_size)
        tree = ref.unflatten(ref.assemble(shards))
        flat = part.flatten(tree, device)
        out[name] = torch.stack([part.shard(flat, j).clone()
                                 for j in transport.ranks])
    return out


def zero_opt_state_to_jax(opt_state: Mapping[str, Any], params, qcfg,
                          n_shards: int, *,
                          reference_backend: str = "jnp"):
    """The reference's ZeRO-1 optimizer state from the port's: the inverse
    of :func:`zero_opt_state_from_jax`.

    ``opt_state``: ``{name: [n_shards, shard_size]}``, every rank's row of
    the port's layout (a stacked run's state, or a checkpoint's gathered
    arrays), tensors or numpy arrays.  Each is unflattened with the port's
    geometry and flattened with the reference's (its ``zero_partitioner``
    of ``qcfg`` with the quanta ``reference_backend`` resolves); returns one
    flat fp32 ``[padded_size]`` numpy vector per state tensor, rank-major
    shards of that layout, as the reference's ``zero_opt_state`` keeps
    them.  ``params``: the port's parameter tree (for its shapes)."""
    from repro_torch.core import qtrain
    part = qtrain.zero_partitioner(qcfg, params, n_shards)
    ref = _reference_partitioner(qcfg, params, n_shards, reference_backend)
    out = {}
    for name, rows in opt_state.items():
        rows = (rows.detach().to("cpu", torch.float32)
                if isinstance(rows, torch.Tensor)
                else torch.from_numpy(np.asarray(rows, np.float32)))
        if tuple(rows.shape) != (n_shards, part.shard_size):
            raise ValueError(f"{name}: shape {tuple(rows.shape)}, the port's "
                             f"layout holds ({n_shards}, {part.shard_size})")
        tree = part.unflatten(part.assemble(rows))
        out[name] = ref.flatten(tree, "cpu").numpy()
    return out


def zero_ckpt_adapter(params, qcfg, transport, *,
                      reference_backend: str = "jnp"):
    """The ``adapt`` hook of :func:`repro_torch.checkpoint.restore` for a
    ZeRO-1 state: an ``.opt_state/<name>`` array in the reference's flat
    ``[padded]`` layout becomes the port's ``[ranks, shard_size]`` rows
    through :func:`zero_opt_state_from_jax`; one of the port's own, every
    rank's rows (``[axis_size, shard_size]``), gives a process that holds
    fewer ranks (one, under ``torchrun``) the rows of its own ranks; every
    other array passes through.  ``params``: the template's parameter
    tree."""
    def adapt(key, arr, like):
        if not (key.startswith(".opt_state/") and like.ndim == 2):
            return arr
        if np.ndim(arr) == 1:
            name = key[len(".opt_state/"):]
            return zero_opt_state_from_jax(
                {name: arr}, params, qcfg, transport,
                reference_backend=reference_backend)[name]
        held = list(transport.ranks)
        if (np.ndim(arr) == 2 and arr.shape[0] == transport.axis_size
                and like.shape[0] == len(held) != arr.shape[0]):
            return np.asarray(arr)[held]
        return arr
    return adapt
