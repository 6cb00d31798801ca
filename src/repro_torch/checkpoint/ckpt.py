"""Atomic, versioned checkpoints in the reference's on-disk format.

Counterpart of ``repro/checkpoint/ckpt.py``, and byte-compatible with it:

    <dir>/step_<N:08d>/arrays.npz + manifest.json

written to a ``.tmp`` sibling and renamed into place, so a crash mid-write
never corrupts the newest checkpoint.  The version-2 manifest carries one
SHA-256 digest per array; :func:`latest_step` verifies the newest step end
to end and walks back past torn or bit-rotted ones, and :func:`restore`
re-verifies every array it reads.  Keys are the reference's
``flatten_tree`` paths (:func:`flatten_tree`): ``.step``,
``.params/<a>/<b>``, ``.opt_state/<name>/...``, ``.dps/<domain>/.<field>``,
``.rng``, ``.last_loss``, ``.guard/.<field>`` — dict keys bare, dataclass
fields with a leading dot, ``None`` subtrees absent; bf16 is widened to fp32.

Where the port's state differs from the reference's, the format is the
reference's and the port converts:

* **The RNG.**  The reference keeps ``jax.random.key(seed)`` and never
  advances it (each step folds in ``step``); its key data under the default
  threefry implementation is the uint32 pair ``[0, seed]``.  The port keeps
  the host ``seed: int``, writes ``.rng`` as ``[0, seed]`` and reads the
  seed back from it.  A key whose first word is not 0 is not ``key(s)`` for
  any seed and has no port counterpart: :func:`restore` refuses it.
* **The step** is an int32 0-d array on disk, a host int in the port.
* **Restore is in place.**  The port's step updates its state in place,
  and under ZeRO-1 the parameter leaves are views of the partitioner's flat
  buffer.  :func:`restore` therefore ``copy_``s each array into the
  template's own tensor (a :class:`~repro_torch.core.qtrain.TrainState`
  built by ``launch.train.setup``, on its device) and never rebinds a leaf:
  a rebound leaf would detach from the buffer the owners step.
* **ZeRO-1's flat optimizer state** is written in the port's layout,
  ``[ranks, shard_size]`` (two-dimensional, so the reference's restore
  refuses it by shape instead of misreading it: the two packages pad
  their flat layouts to different quanta).  Under ``torchrun`` each
  process holds one row: :func:`gather_rows` collects every rank's over
  the transport's process group, and rank 0 writes the same arrays a
  stacked run writes.  A reference ZeRO checkpoint (one flat ``[padded]``
  vector per state tensor) restores into the port, and a port checkpoint
  into one row a process, through ``restore(...,
  adapt=convert.zero_ckpt_adapter(...))``; ``convert.zero_opt_state_to_jax``
  turns the port's rows into the reference's vectors.
* **Async save of an in-place state.**  :meth:`AsyncCheckpointer.save`
  copies every tensor to the host before it returns (the next step
  overwrites them); the background thread only serializes and hashes host
  arrays.  Its timings are kept in ``AsyncCheckpointer.records``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.dps import DpsBundle


def _to_np(x) -> np.ndarray:
    """A host copy of one leaf: tensors copied off the device (or cloned on
    the CPU, whose tensors the next step would overwrite), bf16 widened; a
    placed leaf's whole tensor, built on the host block by block (a
    collective on a process mesh, so every process flattens), so a placed
    state restores onto any mesh or none."""
    from repro_torch.dist.sharding import Placed, gather_to_host
    if isinstance(x, Placed):
        x = gather_to_host(x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _items(node):
    """``(key, child)`` pairs of a tree node in the reference's key naming,
    or None for a leaf."""
    from repro_torch.core.qtrain import TrainState    # qtrain imports this
    if isinstance(node, TrainState):
        return [(".step", np.asarray(node.step, np.int32)),
                (".params", node.params), (".opt_state", node.opt_state),
                (".dps", node.dps), (".rng", rng_of_seed(node.seed)),
                (".last_loss", node.last_loss), (".guard", node.guard)]
    if isinstance(node, DpsBundle):
        return list(node.items())
    if isinstance(node, Mapping):
        return [(k, node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("." + f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _walk(node, prefix: str, fn):
    items = _items(node)
    if items is None:
        fn(prefix, node)
        return
    for k, child in items:
        if child is not None:
            _walk(child, f"{prefix}/{k}" if prefix else k, fn)


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """``{key path: host array}`` of a train state (or any subtree of one),
    keyed as the reference's ``flatten_tree`` keys its own state."""
    flat = {}
    _walk(tree, "", lambda k, v: flat.__setitem__(k, _to_np(v)))
    return flat


def gather_rows(tree, transport):
    """A ZeRO-1 optimizer state held one row a process (``[1, shard_size]``
    tensors) with every rank's rows: each tensor is all-gathered over
    ``transport`` into ``[axis_size, shard_size]`` and copied to the host
    before the next one (a collective: every process calls it).  Returns a
    tree of host arrays, bf16 widened."""
    return tree_lib.map_tree(
        lambda t: _to_np(transport.all_gather(t.contiguous()).view(
            transport.axis_size, -1)), tree)


def rng_of_seed(seed: int) -> np.ndarray:
    """The reference's key data of ``jax.random.key(seed)``: ``[0, seed]``."""
    if not 0 <= int(seed) < 1 << 32:
        raise ValueError(f"seed {seed} does not fit the reference's uint32 "
                         "key word")
    return np.array([0, int(seed)], np.uint32)


def seed_of_rng(arr) -> int:
    """Inverse of :func:`rng_of_seed`; refuses a key that is not
    ``key(s)`` for any seed."""
    arr = np.asarray(arr)
    if arr.shape != (2,) or arr.dtype != np.uint32 or int(arr[0]) != 0:
        raise ValueError(
            f"checkpoint rng key {arr.tolist()} ({arr.dtype}) is not the key "
            "data of jax.random.key(seed) ([0, seed] uint32); the port keeps "
            "a host seed and has no counterpart for it")
    return int(arr[1])


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()


def save_flat(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
              meta: Optional[dict] = None) -> str:
    """Atomic save of already-flattened host arrays; returns the step dir."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    # the digests are taken on two threads while the npz is written
    # (hashlib releases the interpreter lock on large buffers)
    with ThreadPoolExecutor(2) as pool:
        digests = {k: pool.submit(_digest, v) for k, v in flat.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        digests = {k: f.result() for k, f in digests.items()}
    manifest = {"step": step, "keys": sorted(flat), "digests": digests,
                "meta": meta or {}, "version": 2}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None):
    """Atomic synchronous save (per-array SHA-256 digests in the manifest)."""
    return save_flat(ckpt_dir, step, flatten_tree(tree), meta)


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True iff ``step_<N>`` is complete and uncorrupted: the manifest
    parses, the npz opens, every key is present and matches its digest.
    Any failure reads as False, never raises."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        digests = manifest.get("digests")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key in manifest["keys"]:
                arr = data[key]           # raises on truncated members
                if digests is not None and _digest(arr) != digests[key]:
                    return False
        return True
    except Exception:
        return False


def latest_steps(ckpt_dir: str):
    """Every step dir with a manifest (unverified)."""
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                yield int(name.split("_")[1])


def latest_step(ckpt_dir: str, verify: bool = True) -> Optional[int]:
    """Newest restorable step; with ``verify`` each candidate is checked
    newest first and corrupt or torn ones are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    for s in sorted(latest_steps(ckpt_dir), reverse=True):
        if not verify or verify_step(ckpt_dir, s):
            return s
    return None


def load_flat(template, get: Callable[[str], Optional[np.ndarray]],
              defaults: Optional[dict] = None,
              adapt: Optional[Callable] = None):
    """Write the arrays ``get(key)`` returns into ``template`` in place (see
    the module docstring); a key ``get`` lacks comes from ``defaults``, else
    raises.  ``adapt(key, arr, like)`` may reshape an array into the
    template leaf ``like``'s layout first.  Returns ``template``."""
    from repro_torch.core.qtrain import TrainState

    def fetch(key):
        arr = get(key)
        if arr is None:
            if defaults is None or key not in defaults:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = defaults[key]
        return arr

    def put(key, leaf):
        arr = fetch(key)
        if adapt is not None:
            arr = adapt(key, arr, leaf)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(arr.shape)} vs template "
                             f"{tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(torch.as_tensor(arr))

    if isinstance(template, TrainState):
        template.step = int(fetch(".step"))
        template.seed = seed_of_rng(fetch(".rng"))
        for name in ("params", "opt_state", "dps", "last_loss", "guard"):
            if getattr(template, name) is not None:
                _walk(getattr(template, name), "." + name, put)
    else:
        _walk(template, "", put)
    return template


def restore(ckpt_dir: str, step: int, template: Any,
            defaults: Optional[dict] = None,
            adapt: Optional[Callable] = None):
    """Restore ``step_<N>`` into ``template`` in place; returns ``(template,
    meta)``.  Every array read is checked against its digest (a corrupt one
    raises).  ``defaults`` maps key paths to host arrays used when the
    checkpoint lacks them (the schema-upgrade hook, e.g.
    ``qtrain.dps_restore_defaults``); ``adapt``: see :func:`load_flat`."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    digests = manifest.get("digests")   # absent on version-1 checkpoints

    with np.load(os.path.join(path, "arrays.npz")) as data:
        def get(key):
            if key not in data:
                return None
            arr = data[key]
            if digests is not None and _digest(arr) != digests.get(key):
                raise ValueError(
                    f"checkpoint array {key!r} fails its SHA-256 digest "
                    f"(step {step} is corrupt — see ckpt.verify_step)")
            return arr

        load_flat(template, get, defaults, adapt)
    return template, manifest["meta"]


def prune(ckpt_dir: str, keep: int):
    """Delete all but the newest ``keep`` step dirs."""
    if not os.path.isdir(ckpt_dir) or not keep:
        return
    for s in sorted(latest_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """One background save in flight; ``wait()`` before exit.  A failed
    save raises on the next ``save`` or ``wait``.

    ``records`` keeps one dict a save: ``step``, ``bytes``, ``stall_s``
    (the device → host copy the caller waits for, after the device has
    finished its queued work) and, once written, ``write_s`` (npz, SHA-256
    digests, manifest and rename, on the background thread)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self.records = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = flatten_tree(tree)
        rec = {"step": step, "bytes": sum(a.nbytes for a in flat.values()),
               "stall_s": time.perf_counter() - t0}
        self.records.append(rec)

        def work():
            try:
                t1 = time.perf_counter()
                save_flat(self.dir, step, flat, meta)
                rec["write_s"] = time.perf_counter() - t1
                prune(self.dir, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

