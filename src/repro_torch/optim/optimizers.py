"""Optimizers: SGD+momentum (the paper's recipe) and AdamW.

Counterpart of ``repro/optim/optimizers.py``.  Interface:

    opt = make_optimizer(cfg)
    state = opt.init(params)
    opt.update(grads, state, params, count=step)     # in place

and, for ZeRO-1 (one flat slice of the parameters per rank, see
:mod:`repro_torch.dist.sharding`):

    state = opt.init_shard((rows, shard_size), device)
    opt.update_shard(gshard, state_slice, pshard, count, rank=r)  # in place

``update_shard`` runs the same element-wise arithmetic as ``update``, so a
sharded step equals the replicated one bit for bit (fp32 state, no
clipping: the clip's norm sums its squares in another order).

**In place.**  The reference returns the updates and a new state; here
``update`` writes the new parameters and state into ``params`` and
``state``, leaf by leaf, and drops each gradient leaf once used.  At
llama3.2-3b scale one more fp32 copy of the parameters and of the momenta
would need 25.7 GB the card does not have beside them.  The arithmetic is
the reference's, operation for operation (``p + (-lr·mu_new)``), so the
result is the same up to FMA contraction in either backend.

Learning rates and bias corrections are computed on the host in float32
from the step number the trainer already holds (the reference computes
them on the device in float32): no step reads a device value.

``update(..., keep=ok)`` gates every write with the health guards' skip
gate (a bool device scalar): the old value is held where ``ok`` is False.

``state_dtype="bfloat16"`` keeps the state in bf16 with a stochastically
rounded downcast on every update (Gupta et al.).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.fixed_point import fold_seed

_f32 = np.float32


def inv_decay(lr0: float, gamma: float, power: float):
    """The paper's schedule: lr = lr0 · (1 + γ·iter)^-pow, in float32."""
    def f(step: int) -> float:
        return float(_f32(lr0) * (_f32(1.0) + _f32(gamma) * _f32(step))
                     ** _f32(-power))
    return f


def cosine_schedule(lr0: float, warmup: int, total: int, floor: float = 0.1):
    def f(step: int) -> float:
        s = _f32(step)
        warm = s / _f32(max(warmup, 1))
        prog = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(floor) + _f32(1 - floor) * _f32(0.5) * (
            _f32(1) + np.cos(_f32(np.pi) * prog))
        return float(_f32(lr0) * (warm if s < warmup else cos))
    return f


def _sr_cast(x: torch.Tensor, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """Stochastically-rounded downcast (unbiased, Gupta et al.); the noise
    comes from a generator seeded with ``seed`` on x's device."""
    if x.dtype == dtype or dtype == torch.float32:
        return x.to(dtype)
    # bf16: round fp32 mantissa bits 0..15 stochastically (int32 adds wrap
    # as the reference's uint32 ones do)
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    gen = torch.Generator(device=x.device).manual_seed(seed % (1 << 63))
    noise = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32,
                          device=x.device, generator=gen)
    rounded = (bits + noise) & -65536           # & 0xFFFF0000
    return rounded.view(torch.float32).to(dtype)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_lib.leaves(grads)))


def _clip_scale(n: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)


def _clip_by_norm(grads, max_norm: float):
    n = _global_norm(grads)
    scale = _clip_scale(n, max_norm)
    return tree_lib.map_tree(lambda g: (g * scale).to(g.dtype), grads), n


def shard_sq_norm(segments) -> torch.Tensor:
    """Σ g² over one rank's gradient shard (a tensor or its segments), in
    fp32: the per-owner term of the cross-shard clip norm.  The caller sums
    the owners' terms over the data axis (``transport.psum``)."""
    if isinstance(segments, torch.Tensor):
        segments = [segments]
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in segments)


def _clip_by_norm_shard(g: torch.Tensor, max_norm: float,
                        sq_norm: torch.Tensor) -> torch.Tensor:
    """Shard-local clip against the CROSS-SHARD global norm: ``sq_norm``
    is the psum over the data axis of every owner's :func:`shard_sq_norm`
    (zero padding adds nothing)."""
    scale = _clip_scale(torch.sqrt(sq_norm), max_norm)
    return (g * scale).to(g.dtype)


# salt of the sharded steps' stochastic state casts
_SHARD = 0x5348


def _shard_seed(base: int, count: int, rank: int, segment: int) -> int:
    """The bf16 state cast's seed of one rank's shard (segment): per step
    and per rank, as the reference's ``_shard_key`` folds in the axis
    index.  fp32 state ignores it."""
    return fold_seed(base, count, _SHARD, rank, segment)


def _state_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _write(dst: torch.Tensor, src: torch.Tensor, keep, add: bool = False):
    """``dst += src`` (``add``) or ``dst = src``, in place.  ``keep`` (a
    bool device scalar, the health guards' skip gate) selects the new value
    against the old one with ``torch.where`` (an exact select, no host
    sync): a held leaf keeps its bits, a kept one gets the ungated result
    bit for bit, at the cost of one temporary the size of the leaf."""
    if keep is not None:
        torch.where(keep, dst + src if add else src, dst, out=dst)
    elif add:
        dst.add_(src)
    else:
        dst.copy_(src)


def _triples(grads, params, *states):
    """Leaves of grads, params and states in one order, paired up."""
    g = tree_lib.leaves(grads)
    p = tree_lib.leaves(params)
    s = [tree_lib.leaves(t) for t in states]
    if not all(len(x) == len(g) for x in [p] + s):
        raise ValueError("grads, params and optimizer state disagree in "
                         "structure")
    return list(zip(g, p, *s))


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    schedule: str = "inv"          # inv | const
    gamma: float = 1e-4            # paper: 0.0001
    power: float = 0.75            # paper: 0.75
    clip_norm: float = 0.0
    state_dtype: str = "float32"   # float32 | bfloat16 (stochastic-rounded)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    state_dtype: str = "float32"


class SGD:
    def __init__(self, cfg: SGDConfig):
        self.cfg = cfg
        self.sched = (inv_decay(cfg.lr, cfg.gamma, cfg.power)
                      if cfg.schedule == "inv" else lambda s: cfg.lr)

    def init(self, params):
        dt = _state_dtype(self.cfg.state_dtype)
        return {"mu": tree_lib.map_tree(
            lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)}

    def _leaf(self, lr: float, g, p, mu, seed: int, keep=None):
        """One leaf (or flat shard) in place; shared by :meth:`update` and
        :meth:`update_shard`."""
        cfg = self.cfg
        gf = p.to(torch.float32) * cfg.weight_decay
        gf.add_(g)                         # g + wd·p
        mu_new = mu.to(torch.float32) * cfg.momentum
        mu_new.add_(gf)                    # momentum·mu + gf
        del gf
        _write(p, (mu_new * -lr).to(p.dtype), keep, add=True)
        _write(mu, _sr_cast(mu_new, _state_dtype(cfg.state_dtype), seed),
               keep)

    def update(self, grads, state, params, count: int, keep=None):
        """One step, in place: ``params`` and ``state`` are overwritten
        (where ``keep``, a bool device scalar, holds: see :func:`_write`)."""
        cfg = self.cfg
        if cfg.clip_norm:
            grads, _ = _clip_by_norm(grads, cfg.clip_norm)
        lr = self.sched(count)
        with torch.no_grad():
            for i, (g, p, mu) in enumerate(_triples(grads, params,
                                                    state["mu"])):
                self._leaf(lr, g, p, mu, fold_seed(17, count, i), keep)
        return params, state

    # --- ZeRO-1 shard-local interface (see repro_torch.dist.sharding) ---

    def init_shard(self, shape, device=None):
        """State for flat slices of the ZeRO layout: ``shape`` is ``(rows,
        shard_size)`` for the ranks a process holds (or any flat shape).
        Padding carries zero gradients, so its state stays zero."""
        return {"mu": torch.zeros(shape, dtype=_state_dtype(
            self.cfg.state_dtype), device=device)}

    def update_shard(self, grads, state, params, count: int, *,
                     rank: int = 0, segment: int = 0, sq_norm=None):
        """One step on a rank's flat slice, in place: ``params`` (a view
        into the flat parameters) and ``state`` (``{"mu": slice}``) are
        overwritten.  Same element-wise arithmetic as :meth:`update`.
        ``clip_norm`` needs ``sq_norm``, the squared global gradient norm
        (the psum of every owner's :func:`shard_sq_norm`).  ``segment``
        tells apart the pieces of one rank's shard stepped one by one."""
        cfg = self.cfg
        if cfg.clip_norm:
            if sq_norm is None:
                raise ValueError("clip_norm needs the cross-shard sq_norm")
            grads = _clip_by_norm_shard(grads, cfg.clip_norm, sq_norm)
        with torch.no_grad():
            self._leaf(self.sched(count), grads, params, state["mu"],
                       _shard_seed(17, count, rank, segment))
        return params, state


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self.sched = cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)

    def init(self, params):
        dt = _state_dtype(self.cfg.state_dtype)
        z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"m": tree_lib.map_tree(z, params),
                "v": tree_lib.map_tree(z, params)}

    def _bias_corrections(self, count: int):
        cfg = self.cfg
        t = _f32(count) + _f32(1.0)
        return (float(_f32(1.0) - _f32(cfg.b1) ** t),
                float(_f32(1.0) - _f32(cfg.b2) ** t))

    def _leaf(self, lr: float, bc1: float, bc2: float, g, p, m, v,
              seeds, keep=None):
        """One leaf (or flat shard) in place; shared by :meth:`update` and
        :meth:`update_shard`."""
        cfg = self.cfg
        dt = _state_dtype(cfg.state_dtype)
        gf = g.to(torch.float32)
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * gf * gf
        step = m_new / bc1 / (torch.sqrt(v_new / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        _write(p, (-lr * step).to(p.dtype), keep, add=True)
        _write(m, _sr_cast(m_new, dt, seeds[0]), keep)
        _write(v, _sr_cast(v_new, dt, seeds[1]), keep)

    def update(self, grads, state, params, count: int, keep=None):
        """One step, in place: ``params`` and ``state`` are overwritten
        (where ``keep``, a bool device scalar, holds: see :func:`_write`)."""
        cfg = self.cfg
        if cfg.clip_norm:
            grads, _ = _clip_by_norm(grads, cfg.clip_norm)
        lr = self.sched(count)
        bc1, bc2 = self._bias_corrections(count)
        with torch.no_grad():
            for i, (g, p, m, v) in enumerate(_triples(grads, params,
                                                      state["m"],
                                                      state["v"])):
                self._leaf(lr, bc1, bc2, g, p, m, v,
                           (fold_seed(23, count, i, 1),
                            fold_seed(23, count, i, 2)), keep)
        return params, state

    # --- ZeRO-1 shard-local interface (see repro_torch.dist.sharding) ---

    def init_shard(self, shape, device=None):
        """State for flat slices of the ZeRO layout (see
        :meth:`SGD.init_shard`); ``m`` and ``v`` are distinct buffers."""
        dt = _state_dtype(self.cfg.state_dtype)
        return {"m": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def update_shard(self, grads, state, params, count: int, *,
                     rank: int = 0, segment: int = 0, sq_norm=None):
        """One step on a rank's flat slice, in place (see
        :meth:`SGD.update_shard`); ``clip_norm`` (on by default) needs
        ``sq_norm``."""
        cfg = self.cfg
        if cfg.clip_norm:
            if sq_norm is None:
                raise ValueError("clip_norm needs the cross-shard sq_norm")
            grads = _clip_by_norm_shard(grads, cfg.clip_norm, sq_norm)
        bc1, bc2 = self._bias_corrections(count)
        seed = _shard_seed(23, count, rank, segment)
        with torch.no_grad():
            self._leaf(self.sched(count), bc1, bc2, grads, params,
                       state["m"], state["v"],
                       (fold_seed(seed, 1), fold_seed(seed, 2)))
        return params, state


def make_optimizer(cfg):
    if isinstance(cfg, SGDConfig):
        return SGD(cfg)
    if isinstance(cfg, AdamWConfig):
        return AdamW(cfg)
    raise TypeError(f"unknown optimizer config {type(cfg)}")
