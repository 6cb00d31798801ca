"""Per-rank dry run: one rank's bytes, FLOPs and collective bytes of every
(arch × shape × mesh) cell, on ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_3b \\
        --shape train_4k --mesh single --out chiprun_out/dryrun

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell's step for the production meshes — (data 16, model 16) and (pod 2,
data 16, model 16) — and reads XLA's memory and cost analyses.  The port
runs each cell's step once, eagerly, on ``meta`` tensors, which carry
shapes and dtypes and allocate nothing, so no device is needed and the
full-size models fit anywhere:

* the state and the batch are the reference's stand-ins
  (:mod:`repro_torch.launch.specs`), placed by the same rules
  (``train_state_shardings``, ``param_shardings``, ``decode_shardings``,
  ``prefill_shardings``); the steps are the ones the port runs:
  ``build_train_step``'s placed step, and PR 27's placed prefill and
  decode steps (``build_prefill_step``/``build_decode_step``);
* the mesh is seen from ONE rank (:class:`OneRankMesh`): every axis is a
  :class:`OneRankTransport` that holds rank 0, moves nothing, and returns a
  ``meta`` tensor of each collective's result shape — a stacked (16, 16)
  mesh would run 256 ranks' Python passes for the same numbers;
* one rank's **bytes**: its blocks of the state (``held_bytes``) and of
  the batch, and ``spec_bytes`` of the stand-ins under their specs, the
  count the placement promises; its **FLOPs**: the step's matmuls,
  attention and convolutions as ``torch.utils.flop_counter.FlopCounterMode``
  counts them (forward and backward; every layer runs, so no scan-body
  probes are needed); its **collective bytes** by op and dtype, from the
  transports' nodes of a :class:`~repro_torch.analysis.trace.Trace`
  (``collective_wire_bytes``: one rank's payload, ring model).

These are counts of what the step would do, not measurements.

**Stand-ins for host reads.**  A ``meta`` tensor has no value, so a step
that reads one on the host cannot run as it is.  The cells here read none:
the train step runs without the guards (whose degraded flags are the one
host read a step), the DPS controllers and the weight/gradient snaps stay
on the device, and the serving steps' greedy token is an argmax on the
device.  The values themselves are the stand-ins: every number the step
computes is unknown, and only shapes, dtypes and counts come out.

Output: one JSON line a cell on stdout, and with ``--out DIR`` one file a
cell there (a git-ignored directory, e.g. ``chiprun_out/dryrun``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ModelConfig,
                                      ShapeConfig, applicable_shapes,
                                      get_config)
from repro_torch.core import qtrain
from repro_torch.dist.transport import _rec
from repro_torch.dist.sharding import (LogicalRules, held_bytes,
                                       place_tensor, spec_bytes)

META = torch.device("meta")

# the production meshes (repro.launch.mesh's)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# One rank's view of a mesh.
# ---------------------------------------------------------------------------

class _Moved(torch.autograd.Function):
    """A collective's result of ``shape`` made from ``x`` (nothing moves);
    its backward is the transposed collective ``back`` (``None``: the
    identity), recorded with ``back_scale`` times the gradient's bytes."""

    @staticmethod
    def forward(ctx, x, shape, back, back_scale):
        ctx.in_shape, ctx.back, ctx.scale = x.shape, back, back_scale
        return x.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        if ctx.back is None:
            return g, None, None, None
        return (_rec(ctx.back, g, lambda: g.new_empty(ctx.in_shape),
                     scale=ctx.scale), None, None, None)


class OneRankTransport:
    """Rank 0 of an axis of ``n`` ranks: the transports' interface with
    nothing moved.  Every collective is one trace node with one rank's
    payload bytes (``repro_torch.dist.transport``'s convention) and returns
    a tensor of its result's shape made from nothing; autograd passes
    through, each backward the transposed collective."""

    def __init__(self, n: int):
        self.n = int(n)

    @property
    def axis_size(self) -> int:
        return self.n

    @property
    def ranks(self) -> Sequence[int]:
        return (0,)

    # -- the wire's collectives (a leading axis of the one held rank) --

    def all_to_all(self, payload, async_op: bool = False):
        out = _rec("all-to-all", payload,
                   lambda: payload.new_empty(
                       (1, self.n, payload.shape[1] // self.n)))
        return (out, None) if async_op else out

    def all_gather(self, parts):
        return _rec("all-gather", parts,
                    lambda: parts.new_empty((self.n * parts.shape[1],)),
                    scale=self.n)

    def psum(self, t):
        return _rec("all-reduce", t, lambda: t.new_empty(t.shape[1:]))

    pmax = psum

    def gather_rows(self, t):
        return _rec("all-gather", t, lambda: _Moved.apply(
            t, (self.n,) + tuple(t.shape), "all-reduce", 1), scale=self.n)

    def all_to_all_tiled(self, x, split_axis: int, concat_axis: int):
        shape = list(x.shape)              # [1, ...]: the one held block
        shape[split_axis + 1] //= self.n
        shape[concat_axis + 1] *= self.n
        return _rec("all-to-all", x, lambda: _Moved.apply(
            x, tuple(shape), "all-to-all", 1))

    # -- the placed step's collectives (one block, as a list) --

    def gather_blocks(self, xs, dim: int):
        (x,) = xs
        shape = list(x.shape)
        shape[dim] *= self.n
        return [_rec("all-gather", x, lambda: _Moved.apply(
            x, tuple(shape), "reduce-scatter", 1), scale=self.n)]

    def reduce_scatter_blocks(self, xs, dim: int):
        (x,) = xs
        shape = list(x.shape)
        shape[dim] //= self.n
        return [_rec("reduce-scatter", x, lambda: _Moved.apply(
            x, tuple(shape), "all-gather", self.n))]

    def psum_blocks(self, xs, grad: str = "psum"):
        (x,) = xs
        back = None if grad == "identity" else "all-reduce"
        return [_rec("all-reduce", x, lambda: _Moved.apply(
            x, x.shape, back, 1))]

    def copy_blocks(self, xs):
        (x,) = xs
        return [_Moved.apply(x, x.shape, "all-reduce", 1)]

    def pmax_blocks(self, xs):
        (x,) = xs
        with torch.no_grad():
            return [_rec("all-reduce", x, lambda: x.detach().new_empty(
                x.shape))]


class OneRankMesh:
    """A mesh of ``shape`` over ``axes`` seen from rank 0: the names and
    sizes a ``DeviceMesh`` reports (so placement treats it as a process
    mesh of one rank a process), rank 0's coordinate, and a
    :class:`OneRankTransport` an axis."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)
        self._transports = {a: OneRankTransport(n)
                            for a, n in zip(self.mesh_dim_names, self.shape)}

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_coordinate(self):
        return [0] * len(self.shape)

    def transport(self, axis: str) -> OneRankTransport:
        return self._transports[axis]

    def __repr__(self):
        return f"OneRankMesh({dict(zip(self.mesh_dim_names, self.shape))})"


# ---------------------------------------------------------------------------
# The cells.
# ---------------------------------------------------------------------------

def _qcfg() -> qtrain.QuantConfig:
    """The reference dry run's train config: the paper's controller, no
    wire (on a mesh with a model axis the wire and ZeRO-1 fall back)."""
    return qtrain.QuantConfig(enabled=True, controller="paper")


def _optimizer():
    from repro_torch.optim import SGDConfig, make_optimizer
    return make_optimizer(SGDConfig())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _batch_bytes(placed: Dict[str, Any]) -> int:
    return sum(_nbytes(p.blocks[0]) for p in placed.values())


def _place_inputs(specs: Dict[str, torch.Tensor], mesh, rules):
    from repro_torch.launch.specs import _batch_spec
    return {k: place_tensor(v, _batch_spec(mesh, rules, v.shape), mesh)
            for k, v in specs.items()}


def _run_train(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    from repro_torch.launch import specs as specs_lib
    qcfg, opt = _qcfg(), _optimizer()
    state = specs_lib.abstract_train_state(cfg, opt, qcfg, mesh=mesh)
    sh = specs_lib.train_state_shardings(cfg, mesh, rules, opt, qcfg)
    astate = specs_lib.abstract_train_state(cfg, opt, qcfg, mesh=mesh)
    spec = spec_bytes(astate.params, sh.params, mesh)
    for k in sorted(astate.opt_state):
        spec += spec_bytes(astate.opt_state[k], sh.opt_state[k], mesh)
    specs_lib.place_train_state(cfg, state, mesh, rules)
    held = held_bytes((state.params, state.opt_state))[0]
    small = sum(_nbytes(t) for t in _state_tensors(state))
    # the placed step places the global batch itself (over ``batch``)
    batch = specs_lib.train_batch_specs(cfg, shape)
    batch_bytes = spec_bytes(batch, specs_lib.train_batch_shardings(
        cfg, shape, mesh, rules), mesh)
    step = specs_lib.build_train_step(cfg, qcfg, opt, accum_steps=1,
                                      mesh=mesh, rules=rules)
    return (lambda: step(state, batch)), {
        "state_bytes": held + small, "batch_bytes": batch_bytes,
        "spec_bytes": spec + small + batch_bytes}


def _state_tensors(state):
    """The replicated tensors of a train state (the controllers' states,
    the last loss): every rank holds them whole."""
    from repro_torch.core.tagging import tensor_leaves
    return [state.last_loss] + tensor_leaves(
        [state.dps[n] for n in state.dps])


def _serve_params(cfg: ModelConfig, mesh, rules):
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models import registry
    from repro_torch.models.common import abstract_params
    aparams = abstract_params(registry(cfg.family).model_defs(cfg))
    p_sh = specs_lib.param_shardings(cfg, mesh, rules)
    spec = spec_bytes(aparams, p_sh, mesh)
    params = specs_lib.place_serve_state(cfg, mesh, params=aparams,
                                         rules=rules)["params"]
    return params, held_bytes(params)[0], spec


def _run_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    from repro_torch.launch import specs as specs_lib
    params, held, spec = _serve_params(cfg, mesh, rules)
    in_specs = specs_lib.prefill_specs(cfg, shape)
    inputs = _place_inputs(in_specs, mesh, rules)
    step = specs_lib.build_prefill_step(cfg, shape.seq, mesh=mesh,
                                        rules=rules)
    return (lambda: step(params, **inputs)), {
        "state_bytes": held, "batch_bytes": _batch_bytes(inputs),
        "spec_bytes": spec + spec_bytes(
            in_specs, specs_lib.prefill_shardings(cfg, shape, mesh, rules),
            mesh)}


def _run_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    from repro_torch.launch import specs as specs_lib
    params, held, spec = _serve_params(cfg, mesh, rules)
    d = specs_lib.decode_specs(cfg, shape)
    d_sh = specs_lib.decode_shardings(cfg, shape, mesh, rules)
    placed = specs_lib.place_serve_state(cfg, mesh, cache=d["cache"],
                                         tokens=d["tokens"], pos=d["pos"],
                                         rules=rules)
    cache_bytes = held_bytes(placed["cache"])[0]
    step = specs_lib.build_decode_step(cfg, mesh=mesh, rules=rules)
    return (lambda: step(params, placed["tokens"], placed["cache"],
                         placed["pos"])), {
        "state_bytes": held + cache_bytes,
        "batch_bytes": (_nbytes(placed["tokens"].blocks[0])
                        + _nbytes(placed["pos"].blocks[0])),
        "spec_bytes": spec + sum(spec_bytes(d[k], d_sh[k], mesh)
                                 for k in ("tokens", "cache", "pos"))}


KIND_RUNNERS = {"train": _run_train, "prefill": _run_prefill,
                "decode": _run_decode}


def run_cell(arch: str, shape_name: str, mesh_name: str = "single",
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh_shape=None) -> Dict[str, Any]:
    """One cell: ``arch`` (or ``cfg``) at ``shape_name`` (or ``shape``) on
    the ``mesh_name`` production mesh (or a ``(shape, axes)`` pair)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.trace import Trace
    from repro_torch.launch.trace_stats import (collective_wire_bytes,
                                                wire_bytes_summary)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dims, axes = mesh_shape or MESHES[mesh_name]
    mesh, rules = OneRankMesh(dims, axes), LogicalRules()
    t0 = time.perf_counter()
    with torch.device(META):
        run, out = KIND_RUNNERS[shape.kind](cfg, shape, mesh, rules)
        flops = FlopCounterMode(display=False)
        with Trace(ops=False) as tr, flops:
            run()
    wire = collective_wire_bytes(tr)
    out.update(arch=arch, shape=shape.name, kind=shape.kind,
               mesh=dict(zip(axes, dims)), n_devices=math.prod(dims),
               flops=float(flops.get_total_flops()),
               collective_wire_bytes=wire["by_op_dtype"],
               collective_summary=wire_bytes_summary(tr),
               seconds=round(time.perf_counter() - t0, 2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="One rank's bytes, FLOPs and collective bytes of each "
                    "(arch × shape × mesh) cell, on meta tensors.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write one JSON a cell into this directory "
                         "(keep it git-ignored, e.g. chiprun_out/dryrun)")
    args = ap.parse_args(argv)
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    cells = []
    for arch in archs:
        shapes = applicable_shapes(get_config(arch))
        for sh in ([args.shape] if args.shape else shapes):
            if sh not in shapes:
                print(f"SKIP {arch} × {sh}: not applicable", flush=True)
                continue
            cells += [(arch, sh, m) for m in meshes]
    failures = []
    for arch, sh, m in cells:
        tag = f"{arch}__{sh}__{m}"
        try:
            stats = run_cell(arch, sh, m)
        except Exception as e:
            failures.append((tag, repr(e)))
            traceback.print_exc()
            continue
        print(json.dumps({"cell": tag, **stats}), flush=True)
        if args.out:
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(stats, f, indent=1)
    print(f"{len(cells) - len(failures)}/{len(cells)} cells ran", flush=True)
    for tag, err in failures:
        print(f"FAIL {tag}: {err[:300]}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
