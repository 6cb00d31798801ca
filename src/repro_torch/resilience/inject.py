"""Deterministic fault injection: every guard is proven by firing it.

Counterpart of ``repro/resilience/inject.py``.  A :class:`FaultPlan` is
static config handed to the train step:

    nan_grads_at       poison the raw local gradients with NaN at one step
    overflow_storm_at  scale the raw gradients by ``storm_scale`` for
                       ``storm_steps`` consecutive steps, past the wire radix
    wire_flip_at       XOR ``0x40`` into the int8 dispatch-leg payload of
                       the gradient all-reduce at one step (transport
                       corruption, caught by the gradient-norm spike guard)

Host-side faults: :func:`corrupt_checkpoint` (a torn or bit-rotted
``arrays.npz``) and ``launch.train --sigterm-at N`` (a real SIGTERM).

The reference compares a traced step counter inside its compiled step.  The
port's step is a host integer, so whether a fault fires is a host decision:
a clean step runs no injection code at all, and the faulted one runs the
reference's arithmetic (a NaN fill; a product with a power of two, exact in
fp32 and bf16 alike) in place on the step's own gradient tree.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from repro_torch.core import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Fault schedule; ``-1`` disables a fault."""

    nan_grads_at: int = -1
    overflow_storm_at: int = -1
    storm_steps: int = 4
    storm_scale: float = float(2 ** 18)
    wire_flip_at: int = -1

    def any_grad_fault(self) -> bool:
        return self.nan_grads_at >= 0 or self.overflow_storm_at >= 0


def apply_leaf_faults(faults: Optional[FaultPlan], leaf, step: int):
    """The scheduled gradient faults of ``step``, applied in place to one
    raw gradient leaf: what :func:`apply_grad_faults` does to each leaf of a
    tree, for a caller that has the gradients one leaf at a time (the
    overlapped wire's backward hooks).  Returns ``leaf``."""
    if faults is None:
        return leaf
    if step == faults.nan_grads_at:
        leaf.fill_(float("nan"))
    at = faults.overflow_storm_at
    if at >= 0 and at <= step < at + faults.storm_steps:
        leaf.mul_(faults.storm_scale)
    return leaf


def apply_grad_faults(faults: Optional[FaultPlan], grads, step: int):
    """The scheduled gradient faults of ``step``, applied in place to the
    raw local tree ``grads`` (right after the backward, before any stats or
    wire encode), leaf by leaf.  Returns ``grads``."""
    if faults is not None:
        for g in tree_lib.leaves(grads):
            apply_leaf_faults(faults, g, step)
    return grads


def payload_fault_fn(faults: Optional[FaultPlan], step: int):
    """The wire-payload corruption hook of ``step`` for
    :class:`repro_torch.dist.collectives.TreeAllReduce`: ``None`` unless a
    flip is scheduled at this step, else a callable that XORs ``0x40`` into
    the encoded int8 dispatch-leg buffer in place (bit 6 of every byte: a
    dense, sign-preserving corruption that decodes to a ±2^(6−FL) offset on
    every element, finite, so the NaN guard must not fire)."""
    if faults is None or step != faults.wire_flip_at:
        return None
    return lambda buf: buf.bitwise_xor_(0x40)


def corrupt_checkpoint(ckpt_dir: str, step: int, mode: str = "truncate"):
    """Corrupt a saved checkpoint in place.

    ``mode="truncate"`` chops ``arrays.npz`` to half its bytes (a torn write
    that survived the rename); ``mode="bitflip"`` flips one bit in the
    largest array's payload and rewrites the npz as a valid zip, so only the
    manifest's SHA-256 digests can catch it."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "bitflip":
        with np.load(path) as data:
            arrays = {k: np.array(data[k]) for k in data.files}
        key = max(arrays, key=lambda k: arrays[k].nbytes)
        buf = arrays[key].view(np.uint8).reshape(-1)
        buf[len(buf) // 2] ^= 0x10
        np.savez(path, **arrays)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path
