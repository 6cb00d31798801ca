"""Shape-only stand-ins and placement specs for every (arch × shape) cell.

Counterpart of ``repro/launch/specs.py``.  The ``*_specs`` functions return
tensors on the ``meta`` device in place of the reference's
``ShapeDtypeStruct``s: nothing is allocated.  The ``*_shardings`` functions
resolve the logical axes of every train-state, batch, cache and prefill
leaf against a mesh through the divisibility-fallback rules
(:class:`~repro_torch.dist.sharding.LogicalRules`); where the reference
returns ``NamedSharding``s they return specs, tuples with one entry per
dimension, equal to the reference's ``PartitionSpec``s entry for entry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import qtrain
from repro_torch.core import tree as tree_lib
from repro_torch.dist.sharding import (LogicalRules, _axis_sizes,
                                       axis_rules, axis_transport, is_placed,
                                       place, place_tensor, placed_argmax,
                                       tree_specs)
from repro_torch.dist.transport import shared_outputs
from repro_torch.models import registry
from repro_torch.models.common import abstract_params, logical_tree

REPLICATED = ()


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_spec(mesh, rules, shape):
    return rules.spec(("batch",) + (None,) * (len(shape) - 1), shape, mesh)


def _replicated(tree):
    """The replicated spec at every tensor of a state tree (dicts, the DPS
    registry, dataclasses of tensors)."""
    if isinstance(tree, torch.Tensor):
        return REPLICATED
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _replicated(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if hasattr(tree, "items"):
        out = {k: _replicated(v) for k, v in tree.items()}
        return out if isinstance(tree, dict) else type(tree)(out)
    return tree


# ---------------------------------------------------------------------------
# Batches.
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Stand-ins of one global training batch."""
    B, S = shape.batch, shape.seq
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        batch["tokens"] = _meta((B, S - cfg.n_patches + 1), torch.int32)
        batch["vision_embeds"] = _meta((B, cfg.n_patches, cfg.d_model),
                                       torch.bfloat16)
    elif cfg.family == "encdec":
        batch["tokens"] = _meta((B, S + 1), torch.int32)
        batch["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, S + 1), torch.int32)
    return batch


def train_batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                          rules: LogicalRules):
    return {k: _batch_spec(mesh, rules, v.shape)
            for k, v in train_batch_specs(cfg, shape).items()}


# ---------------------------------------------------------------------------
# Train state.
# ---------------------------------------------------------------------------

def param_shardings(cfg: ModelConfig, mesh, rules: LogicalRules):
    defs = registry(cfg.family).model_defs(cfg)
    return tree_specs(logical_tree(defs), abstract_params(defs), mesh, rules)


def opt_state_shardings(optimizer, p_shards):
    from repro_torch.optim.optimizers import SGD, AdamW
    if isinstance(optimizer, SGD):
        return {"mu": p_shards}
    if isinstance(optimizer, AdamW):
        return {"m": p_shards, "v": p_shards}
    raise TypeError(type(optimizer))


def zero_engaged(qcfg: qtrain.QuantConfig, mesh) -> bool:
    """Does the ZeRO-1 path engage for (qcfg, mesh)?  The reference's
    ``zero_opt_engaged(qcfg, mesh)``: a pure data-parallel mesh (every other
    axis of size 1) whose data transport
    :func:`repro_torch.core.qtrain.zero_opt_engaged` accepts."""
    if mesh is None:
        return False
    sizes = _axis_sizes(mesh)
    if "data" not in sizes or any(n > 1 for a, n in sizes.items()
                                  if a != "data"):
        return False
    return qtrain.zero_opt_engaged(qcfg, axis_transport(mesh, "data"))


def _abstract_opt_state(aparams, optimizer, qcfg: qtrain.QuantConfig, mesh):
    """Optimizer-state stand-ins in the layout the step will use: under
    ZeRO-1 the flat padded vector of :func:`qtrain.zero_partitioner`, whole
    (placed over the data axis, rank ``r`` holds shard ``r``); otherwise
    ``optimizer.init``'s tree."""
    if zero_engaged(qcfg, mesh):
        part = qtrain.zero_partitioner(qcfg, aparams, qcfg.zero_opt_shards)
        return optimizer.init_shard((part.padded_size,), "meta")
    return optimizer.init(aparams)


def train_state_shardings(cfg: ModelConfig, mesh, rules: LogicalRules,
                          optimizer, qcfg: qtrain.QuantConfig):
    p_shards = param_shardings(cfg, mesh, rules)
    if zero_engaged(qcfg, mesh):
        # ZeRO-1: every optimizer-state leaf is one flat vector over the
        # data axis, 1/n of the replicated bytes a rank
        aparams = abstract_params(registry(cfg.family).model_defs(cfg))
        opt_shards = {k: ("data",) for k in
                      _abstract_opt_state(aparams, optimizer, qcfg, mesh)}
    else:
        opt_shards = opt_state_shardings(optimizer, p_shards)
    # the DPS registry and the guard state are replicated scalars and tiny
    # [D] vectors on every rank
    guard = None
    if qcfg.guards is not None:
        from repro_torch.resilience import guards as guards_lib
        guard = _replicated(guards_lib.init_guard_state(qcfg.plan(), "meta"))
    return qtrain.TrainState(
        step=REPLICATED, params=p_shards, opt_state=opt_shards,
        dps=_replicated(qtrain.init_dps_bundle(qcfg, "meta")),
        seed=REPLICATED, last_loss=REPLICATED, guard=guard)


def _place_into(tree, specs, mesh) -> None:
    """Each tensor of a dict tree replaced by its placed blocks, one leaf at
    a time, so a whole leaf is freed as soon as it is placed (unless the
    caller holds it)."""
    for k in sorted(tree):
        if isinstance(tree[k], torch.Tensor):
            tree[k] = place_tensor(tree[k], specs[k], mesh)
        else:
            _place_into(tree[k], specs[k], mesh)


def place_train_state(cfg: ModelConfig, state: qtrain.TrainState, mesh,
                      rules: Optional[LogicalRules] = None
                      ) -> qtrain.TrainState:
    """Place a whole train state over ``mesh`` by
    :func:`train_state_shardings`' specs, in place: every parameter leaf
    and every optimizer-state leaf (placed like its parameter) becomes a
    :class:`~repro_torch.dist.sharding.Placed` of the blocks this process
    holds; the DPS registry, the step and the seeds stay replicated.
    Returns ``state``."""
    specs = param_shardings(cfg, mesh, rules or LogicalRules())
    _place_into(state.params, specs, mesh)
    for sub in state.opt_state.values():
        _place_into(sub, specs, mesh)
    return state


def placement_engaged(qcfg: qtrain.QuantConfig, mesh) -> bool:
    """Does ``build_train_step`` build the placed step on ``mesh``?  A
    model axis above 1 always (the int8 wire and ZeRO-1 fall back there),
    or any other axis above 1 (FSDP binds the data axis) without the int8
    wire or ZeRO-1, which keep the replicated parameters of a pure data
    mesh."""
    if mesh is None:
        return False
    sizes = _axis_sizes(mesh)
    if sizes.get("model", 1) > 1:
        return True
    wire_or_zero = (qcfg.grad_allreduce_bits is not None
                    or qcfg.zero_opt_shards is not None)
    return not wire_or_zero and any(n > 1 for n in sizes.values())


def abstract_train_state(cfg: ModelConfig, optimizer,
                         qcfg: qtrain.QuantConfig, mesh=None):
    """A ``TrainState`` of stand-ins (the trainer's master dtype).
    ``mesh`` matters only under ``qcfg.zero_opt_shards``: the optimizer
    state switches to the flat ZeRO layout exactly when a step on this
    mesh would."""
    mod = registry(cfg.family)
    aparams = abstract_params(mod.model_defs(cfg, cfg.master_dtype()))
    guard = None
    if qcfg.guards is not None:
        from repro_torch.resilience import guards as guards_lib
        guard = guards_lib.init_guard_state(qcfg.plan(), "meta")
    return qtrain.TrainState(
        step=0, params=aparams,
        opt_state=_abstract_opt_state(aparams, optimizer, qcfg, mesh),
        dps=qtrain.init_dps_bundle(qcfg, "meta"), seed=0,
        last_loss=_meta((), torch.float32), guard=guard)


# ---------------------------------------------------------------------------
# Decode / prefill.
# ---------------------------------------------------------------------------

def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens, cache, pos) stand-ins of one serving step."""
    B, S = shape.batch, shape.seq
    return {"tokens": _meta((B, 1), torch.int32),
            "cache": registry(cfg.family).cache_struct(cfg, B, S),
            "pos": _meta((B,), torch.int32)}


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     rules: LogicalRules):
    B, S = shape.batch, shape.seq
    mod = registry(cfg.family)
    return {"tokens": rules.spec(("batch", None), (B, 1), mesh),
            "cache": tree_specs(mod.cache_logical(cfg),
                                mod.cache_struct(cfg, B, S), mesh, rules),
            "pos": rules.spec(("batch",), (B,), mesh)}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.batch, shape.seq
    out: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if cfg.family == "vlm":
        out["tokens"] = _meta((B, S - cfg.n_patches), torch.int32)
        out["vision_embeds"] = _meta((B, cfg.n_patches, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return out


def prefill_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      rules: LogicalRules):
    return {k: _batch_spec(mesh, rules, v.shape)
            for k, v in prefill_specs(cfg, shape).items()}


# ---------------------------------------------------------------------------
# Step builders.
# ---------------------------------------------------------------------------

def per_layer_wire_qcfg(cfg: ModelConfig,
                        qcfg: qtrain.QuantConfig) -> qtrain.QuantConfig:
    """``qcfg`` with one ``wire_grads`` ⟨IL, FL⟩ per parameter leaf of this
    arch, counted from the declarations (no tensor exists yet).  A no-op
    unless the compressed gradient sync is configured."""
    return qcfg.with_per_layer_wire(
        abstract_params(registry(cfg.family).model_defs(cfg)))


def wire_bucket_plan(cfg: ModelConfig, qcfg: qtrain.QuantConfig):
    """The :class:`~repro_torch.dist.overlap.BucketPlan` a ``wire_overlap``
    step buckets this arch's gradients under, from the declarations (the
    derivation ``qtrain.make_train_step`` makes); ``None`` unless the
    overlapped wire is configured."""
    if not (qcfg.wire_overlap and qcfg.grad_allreduce_bits is not None):
        return None
    from repro_torch.dist import overlap as overlap_lib
    aparams = abstract_params(registry(cfg.family).model_defs(cfg))
    sizes = tuple(l.numel() for l in tree_lib.leaves(aparams))
    return overlap_lib.plan_buckets(
        sizes, qcfg.wire_bucket_elems or overlap_lib.DEFAULT_BUCKET_ELEMS)


def build_train_step(cfg: ModelConfig, qcfg: qtrain.QuantConfig, optimizer,
                     accum_steps: Optional[int] = None, mesh=None,
                     faults=None, rules: Optional[LogicalRules] = None):
    """Train step for one arch.

    Without ``mesh`` (or on a mesh of one rank) the replicated step; a
    model axis of the MoE layer's expert-parallel dispatch is then reached
    by calling it under :func:`~repro_torch.dist.sharding.axis_rules`.
    With the int8 wire or ZeRO-1 on a pure data mesh, the replicated
    parameters' data-parallel step over the data axis's transport (the
    reference drops ``fsdp`` there).  Otherwise (:func:`placement_engaged`)
    the placed step (:func:`repro_torch.core.qtrain.make_placed_train_step`)
    on a state placed by :func:`place_train_state` under ``rules``: FSDP
    over data, tensor parallelism over model, as the reference's
    ``jax.jit`` with ``in_shardings`` places it: every family's
    ``placed_loss_fn``.  There the int8 wire and ZeRO-1 warn and fall back
    as the reference's step does (``wire_sync_active`` and
    ``zero_opt_active`` False), and ``faults`` and ``qcfg.guards`` run as
    on the replicated step."""
    mod = registry(cfg.family)
    accum = cfg.train_accum if accum_steps is None else accum_steps
    if placement_engaged(qcfg, mesh):
        return qtrain.make_placed_train_step(
            mod.placed_loss_fn(cfg), optimizer, qcfg, mesh,
            rules or LogicalRules(), accum_steps=accum, faults=faults)
    transport = (axis_transport(mesh, "data")
                 if mesh is not None and "data" in _axis_sizes(mesh) else None)
    return qtrain.make_train_step(mod.loss_fn(cfg), optimizer, qcfg,
                                  accum_steps=accum, transport=transport,
                                  faults=faults)


def _placed_serving(mesh) -> bool:
    return mesh is not None and any(n > 1 for n in _axis_sizes(mesh).values())


def place_serve_state(cfg: ModelConfig, mesh, params=None, cache=None,
                      rules: Optional[LogicalRules] = None, **inputs):
    """Place a whole serving state over ``mesh``: ``params`` in place by
    :func:`param_shardings` (each leaf freed as it is placed, unless the
    caller holds it), ``cache`` (a family's contiguous decode cache) by
    :func:`decode_shardings`' cache specs at its batch and length, and
    each of ``inputs`` (``tokens``, ``pos``, ``vision_embeds``,
    ``frames``) over ``batch``, as :func:`prefill_shardings` and
    :func:`decode_shardings` lay them out.  Returns ``{"params": ...,
    "cache": ..., <input>: ...}`` for what was given."""
    rules = rules or LogicalRules()
    out = {}
    if params is not None:
        _place_into(params, param_shardings(cfg, mesh, rules), mesh)
        out["params"] = params
    if cache is not None:
        out["cache"] = place(cache, tree_specs(
            registry(cfg.family).cache_logical(cfg), cache, mesh, rules), mesh)
    for k, v in inputs.items():
        out[k] = place_tensor(v, _batch_spec(mesh, rules, v.shape), mesh)
    return out


def build_decode_step(cfg: ModelConfig, mesh=None,
                      rules: Optional[LogicalRules] = None,
                      with_logits: bool = False):
    """The greedy serving step ``(params, tokens (B, 1), cache, pos (B,))
    -> (next_tok (B, 1) int32, cache, pos + 1)``, and with ``with_logits``
    the step's logits (B, V) after them; the cache is written in place.
    With a ``mesh`` of more than one rank it runs under ``axis_rules(mesh,
    rules)`` on a state placed by :func:`place_serve_state`: each rank its
    rows of the batch, its heads and its block of the cache, ``next_tok``
    the whole-vocabulary argmax over the logits' ``vocab_out`` blocks
    (ties to the lowest index, as ``jnp.argmax`` breaks them), laid out
    like the tokens."""
    mod = registry(cfg.family)

    def serve_step(params, tokens, cache, pos):
        logits, new_cache = mod.decode_step(cfg, params, tokens, cache, pos)
        # greedy next token and advanced positions: the serving loop's
        # fixpoint
        if is_placed(logits):
            out = (placed_argmax(logits).map(
                lambda t: t.to(torch.int32)[:, None], spec=tokens.spec),
                new_cache, pos.map(lambda t: t + 1))
        else:
            out = (torch.argmax(logits, dim=-1).to(torch.int32)[:, None],
                   new_cache, pos + 1)
        return out + (logits,) if with_logits else out

    return _under_rules(serve_step, mesh, rules)


def build_prefill_step(cfg: ModelConfig, max_seq: int, mesh=None,
                       rules: Optional[LogicalRules] = None):
    """``(params, tokens, **inputs) -> (last logits (B, V), cache padded
    to max_seq, pos)``.  With a ``mesh`` of more than one rank it runs
    under ``axis_rules(mesh, rules)`` on parameters and inputs placed by
    :func:`place_serve_state` (the inputs as :func:`prefill_shardings`
    lays them out): the logits come out placed over their vocab split,
    the cache placed by the family's ``cache_logical`` (what
    :func:`decode_shardings` gives it), ``pos`` over ``batch``."""
    mod = registry(cfg.family)

    def prefill_step(params, **inputs):
        return mod.prefill(cfg, params, inputs.pop("tokens"), max_seq,
                           **inputs)

    return _under_rules(prefill_step, mesh, rules)


def _under_rules(step, mesh, rules):
    """``step`` under ``axis_rules(mesh, rules)``, outside autograd, a
    stacked mesh's replicated results shared by their ranks
    (:func:`~repro_torch.dist.transport.shared_outputs`)."""
    if not _placed_serving(mesh):
        return step
    rules = rules or LogicalRules()

    def placed_step(*args, **kwargs):
        with axis_rules(mesh, rules), torch.no_grad(), shared_outputs():
            return step(*args, **kwargs)

    return placed_step
