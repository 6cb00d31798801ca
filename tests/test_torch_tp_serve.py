"""Placed prefill and decode: every family's contiguous serving step on a
state placed over a (data × model) mesh, against the JAX package's own
prefill and decode steps jitted under ``prefill_shardings`` and
``decode_shardings`` (job ``sharded_serve``, as ``repro.launch.dryrun``
compiles its prefill and decode cells).

* Smoke llama3.2-3b (its cache at ``kv_cache_bits`` 16, the fp32 compute
  dtype here, and 8), qwen3-moe, deepseek-v2 (MLA + MoE), internvl2 (a
  ``vision_embeds`` prefix), mamba2, zamba2 (5 blocks: two shared
  invocations and a remainder) and whisper (``frames``), from the
  reference's parameters (``convert.params_from_jax``), on stacked (1, 4)
  and (2, 4) meshes: the placed prefill of a 12-token prompt, then 3
  decode steps teacher-forced from a numpy token array.  Held to the
  reference's sharded steps on a (2, 4) mesh — a MoE model's to the
  reference's on the same mesh, whose all-to-all capacity in prefill is
  each rank's — the logits within ``LOGIT_RTOL`` of the largest logit,
  the greedy tokens equal wherever the top-2 margin exceeds twice that,
  the gathered caches within ``CACHE_RTOL`` of their largest entry (int8
  ones bit-equal but within 32·``CACHE_RTOL`` of a ⟨3, 5⟩ rounding
  boundary of the port's 16-bit run, where a sum in another order may
  take the neighbour), ``pos`` equal; the bytes each rank holds of the
  cache ``spec_bytes`` of ``decode_shardings``' cache.
* The same runs against the port's unsharded steps (a MoE model's under
  the mesh's binding, so that both take the all-to-all in prefill).
* A whole cache placed by ``place_serve_state`` decodes as the placed
  prefill's; a mesh of one rank builds the unsharded steps; the greedy
  token over ``vocab_out`` blocks breaks ties to the lowest index; at
  S = 1 the residual's ``tp_seq`` replicates.
* Over gloo: llama in 4 processes at (1, 4), the stacked run's results.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.dist.sharding import (LogicalRules, Placed, StackedMesh,
                                       axis_rules, gather_placed, held_bytes,
                                       place_tensor, placed_argmax,
                                       spec_bytes)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import registry
from test_torch_jaxref import one_thread, run_reference, unflatten  # noqa: F401

MESHES = [(1, 4), (2, 4)]
REF_MESH = (2, 4)
B, PROMPT, STEPS, MAX_SEQ = 8, 12, 3, 20
# fp32 at smoke size: the placed sums run in other orders than the
# reference's partitioned ones and the port's whole ones (measured under
# 1e-6 of the largest logit and of the largest cache entry)
LOGIT_RTOL = 1e-5
CACHE_RTOL = 1e-5
# tag -> (arch, overrides)
CASES = {
    "llama": ("llama3_2_3b", None),
    "llama_int8": ("llama3_2_3b", {"kv_cache_bits": 8}),
    "qwen3_moe": ("qwen3_moe_30b_a3b", None),
    "deepseek_v2": ("deepseek_v2_236b", None),
    "internvl2": ("internvl2_26b", None),
    "mamba2": ("mamba2_1_3b", None),
    "zamba2": ("zamba2_7b", {"n_layers": 5}),
    "whisper": ("whisper_medium", None),
}


def _cfg(tag):
    arch, over = CASES[tag]
    return dataclasses.replace(smoke(get_config(arch)), **(over or {}))


def _ref_tag(tag, shape):
    """The reference run a placed run at ``shape`` is held to: the (2, 4)
    one, a MoE model's on its own shape."""
    shape = tuple(shape) if _cfg(tag).n_experts else REF_MESH
    return f"{tag}_{shape[0]}x{shape[1]}"


def _whole_tag(tag):
    """The reference run that also serves the unsharded steps."""
    return _ref_tag(tag, MESHES[0])


def _inputs(tag):
    """The prompt, the teacher-forced tokens and the non-token inputs,
    from a numpy seed (one draw for both llama cases)."""
    cfg = _cfg(tag)
    g = np.random.default_rng(len(CASES[tag][0]))
    out = {"tokens": g.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32),
           "steps": g.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = g.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = g.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for rtag in sorted({_ref_tag(t, s) for t in CASES for s in MESHES}):
        tag, mesh = rtag.rsplit("_", 1)
        arch, over = CASES[tag]
        jobs.append({"job": "sharded_serve", "tag": rtag,
                     "kw": {"arch": arch, "max_seq": MAX_SEQ,
                            "mesh": [int(n) for n in mesh.split("x")],
                            "overrides": over,
                            "whole": rtag == _whole_tag(tag)}})
        arrays.update({f"{rtag}/{k}": v for k, v in _inputs(tag).items()})
    return run_reference(jobs, arrays, host_devices=8)


def _params(ref, tag):
    return params_from_jax(unflatten(ref, f"{_whole_tag(tag)}/params/"),
                           _cfg(tag), "cpu")


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

def _flat(cache, prefix):
    """A cache tree (dicts, tuples) as ``{key: fp32 numpy}`` (placed
    leaves gathered), keyed as the reference job keys it."""
    if isinstance(cache, tuple):
        cache = {str(i): c for i, c in enumerate(cache)}
    if isinstance(cache, dict):
        out = {}
        for k, c in cache.items():
            out.update(_flat(c, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(cache).astype(np.float32)}


def _np(t):
    return (gather_placed(t) if isinstance(t, Placed) else t).to(
        torch.float32 if t.dtype.is_floating_point else t.dtype).numpy()


def _serve(cfg, params, inputs, mesh=None, bind=None):
    """The port's prefill and ``STEPS`` teacher-forced decode steps
    (``build_decode_step(..., with_logits=True)``), whole or placed over
    ``mesh`` (``bind``: a mesh whose rules a whole run runs under).
    Returns the outputs keyed as the reference job keys them, and with a
    mesh the bytes each rank holds of the cache."""
    steps = torch.from_numpy(inputs["steps"])
    given = {k: torch.from_numpy(v) for k, v in inputs.items()
             if k != "steps"}
    prefill = specs.build_prefill_step(cfg, MAX_SEQ, mesh=mesh)
    serve_step = specs.build_decode_step(cfg, mesh=mesh, with_logits=True)
    if mesh is not None:
        state = specs.place_serve_state(cfg, mesh, params=params, **given)
        params, given = state.pop("params"), state
    out = {}
    with (axis_rules(bind, LogicalRules()) if bind is not None
          else contextlib.nullcontext()):
        logits, cache, pos = prefill(params, **given)
        out["prefill_logits"] = _np(logits)
        out.update(_flat(cache, "prefill_cache/"))
        out["prefill_pos"] = _np(pos)
        if mesh is not None:
            out["held_bytes"] = held_bytes(cache)
        toks, lgs = [], []
        for i in range(STEPS):
            t = steps[:, i:i + 1]
            if mesh is not None:
                t = specs.place_serve_state(cfg, mesh, tokens=t)["tokens"]
            nxt, cache, pos, lg = serve_step(params, t, cache, pos)
            toks.append(_np(nxt))
            lgs.append(_np(lg))
    out["next_tok"] = np.concatenate(toks, 1)
    out["decode_logits"] = np.stack(lgs, 1)
    out.update(_flat(cache, "decode_cache/"))
    out["decode_pos"] = _np(pos)
    return out


@pytest.fixture(scope="module")
def port(ref):
    """``port(tag, shape, placed)``: the port's run of ``tag`` from the
    reference's parameters, placed over a stacked mesh of ``shape`` or,
    not ``placed``, whole (a MoE model's under that mesh's binding); each
    run made once."""
    runs = {}

    def run(tag, shape, placed):
        key = (tag, tuple(shape), placed)
        if key not in runs:
            cfg = _cfg(tag)
            mesh = StackedMesh(shape, ("data", "model"))
            runs[key] = _serve(cfg, _params(ref, tag), _inputs(tag),
                               mesh if placed else None,
                               bind=None if placed or not cfg.n_experts
                               else mesh)
        return runs[key]

    return run


def _hold_int8(got, want, twin, what):
    """Int8 caches (as fp32) bit-equal, but where the value packed —
    ``twin``, the same cache from a 16-bit run — lies within
    32·CACHE_RTOL of a rounding boundary of the ⟨3, 5⟩ grid: there a sum
    in another order may round to the neighbour (one grid step)."""
    off = got != want
    if off.any():
        assert np.abs(got - want)[off].max() == 1, what
        t = twin[off] * 32
        assert np.abs(np.abs(t - np.floor(t)) - 0.5).max() <= \
            32 * CACHE_RTOL, what


def _hold(cfg, got, want, twin=None):
    """``got`` (the port's outputs) against ``want`` (``{key: array}`` of
    the same keys), within this file's tolerances."""
    V = cfg.vocab
    for k in ("prefill_logits", "decode_logits"):
        g, w = got[k][..., :V], want[k][..., :V]
        err = float(np.abs(g - w).max())
        assert err <= LOGIT_RTOL * float(np.abs(w).max()), (k, err)
    # the greedy tokens: equal wherever the top-2 margin is clear
    top2 = np.sort(want["decode_logits"][..., :V], -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > \
        2 * LOGIT_RTOL * float(np.abs(top2).max())
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["next_tok"][clear],
                                  want["next_tok"][clear])
    for k in ("prefill_pos", "decode_pos"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = sorted(k for k in want if "_cache/" in k)
    assert keys == sorted(k for k in got if "_cache/" in k)
    for k in keys:
        if cfg.kv_cache_bits == 8 and twin is not None and k in twin:
            _hold_int8(got[k], want[k], twin[k], k)
        else:
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= CACHE_RTOL * float(np.abs(want[k]).max()), (k, err)


def _ref_out(ref, rtag, run):
    pre = f"{rtag}/{run}/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _twin(tag, shape, port):
    """The 16-bit run of an int8 case's computation (the values its cache
    packs): the same prompt, tokens and weights."""
    if _cfg(tag).kv_cache_bits != 8:
        return None
    return port(tag.replace("_int8", ""), shape, True)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", list(CASES))
def test_placed_serving_matches_reference_sharded_steps(ref, port, tag,
                                                        shape):
    cfg = _cfg(tag)
    got = port(tag, shape, True)
    _hold(cfg, got, _ref_out(ref, _ref_tag(tag, shape), "sharded"),
          _twin(tag, shape, port))
    # every rank holds its blocks of the cache, decode_shardings' bytes
    mesh = StackedMesh(shape, ("data", "model"))
    mod = registry(cfg.family)
    struct = mod.cache_struct(cfg, B, MAX_SEQ)
    want = spec_bytes(struct, specs.decode_shardings(
        cfg, type("S", (), {"batch": B, "seq": MAX_SEQ})(), mesh,
        LogicalRules())["cache"], mesh)
    assert got["held_bytes"] == [want] * mesh.size
    # the batch splits over data: at most 1/2 of the whole cache a rank
    whole = sum(math.prod(s.shape) * s.element_size()
                for s in _leaves(struct))
    assert want * shape[0] <= whole


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", list(CASES))
def test_placed_serving_matches_unsharded_steps(ref, port, tag, shape):
    """The port's placed run against its own whole run; the reference's
    sharded run agrees with its unsharded one but where a MoE model's
    all-to-all capacity parts them."""
    cfg = _cfg(tag)
    whole = port(tag, shape, False)
    _hold(cfg, port(tag, shape, True), whole,
          None if cfg.kv_cache_bits != 8 else port("llama", shape, False))
    if not cfg.n_experts and shape == REF_MESH:
        _hold(cfg, _ref_out(ref, _ref_tag(tag, shape), "sharded"),
              _ref_out(ref, _whole_tag(tag), "whole"),
              None if cfg.kv_cache_bits != 8 else _ref_out(
                  ref, _whole_tag("llama"), "whole"))


def test_a_placed_whole_cache_decodes_as_the_placed_prefill(ref, port):
    """The unsharded prefill's cache and ``pos``, placed by
    ``place_serve_state``, then the placed serving step: the tokens, cache
    and ``pos`` of the placed prefill's run."""
    cfg = _cfg("llama")
    inputs = _inputs("llama")
    mod = registry(cfg.family)
    _, cache, pos = mod.prefill(cfg, _params(ref, "llama"),
                                torch.from_numpy(inputs["tokens"]), MAX_SEQ)
    mesh = StackedMesh((2, 4), ("data", "model"))
    state = specs.place_serve_state(cfg, mesh, params=_params(ref, "llama"),
                                    cache=cache, pos=pos)
    step = specs.build_decode_step(cfg, mesh=mesh)
    c, p, toks = state["cache"], state["pos"], []
    for i in range(STEPS):
        t = specs.place_serve_state(
            cfg, mesh, tokens=torch.from_numpy(inputs["steps"][:, i:i + 1]))
        nxt, c, p = step(state["params"], t["tokens"], c, p)
        toks.append(_np(nxt))
    want = port("llama", (2, 4), True)
    got = _flat(c, "decode_cache/")
    for k, v in got.items():
        err = float(np.abs(v - want[k]).max())
        assert err <= CACHE_RTOL * float(np.abs(want[k]).max()), k
    np.testing.assert_array_equal(np.concatenate(toks, 1), want["next_tok"])
    np.testing.assert_array_equal(_np(p), want["decode_pos"])


def test_a_one_rank_mesh_builds_the_unsharded_steps(ref):
    """On a (1, 1) mesh ``build_prefill_step``/``build_decode_step`` give
    the unsharded steps: whole tensors in and out, bit for bit the
    mesh-less run's."""
    cfg = _cfg("llama")
    inputs = _inputs("llama")
    one = StackedMesh((1, 1), ("data", "model"))
    runs = [_serve(cfg, _params(ref, "llama"), inputs, None, bind=m)
            for m in (None, one)]
    pre = specs.build_prefill_step(cfg, MAX_SEQ, mesh=one)
    logits, _, _ = pre(_params(ref, "llama"),
                       tokens=torch.from_numpy(inputs["tokens"]))
    assert isinstance(logits, torch.Tensor)
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)


@pytest.mark.parametrize("case", ["across_blocks", "within_a_block"])
def test_greedy_token_breaks_ties_to_the_lowest_index(case):
    """The argmax over ``vocab_out`` blocks (4 blocks of 4): an equal
    largest value in two blocks, or twice in one block, takes the lower
    index, as ``jnp.argmax`` (and ``torch.argmax`` on the whole row)
    breaks ties."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, generator=g)
    at = {"across_blocks": (5, 9), "within_a_block": (12, 13)}[case]
    for i in at:
        x[0, i] = 10.0
    x[1, 7] = x[1, 3] = 9.0
    mesh = StackedMesh((1, 4), ("data", "model"))
    got = placed_argmax(place_tensor(x, (None, "model"), mesh))
    assert gather_placed(got).tolist() == [at[0], 3]
    assert gather_placed(got).tolist() == torch.argmax(x, -1).tolist()


def test_decode_activations_replicate_tp_seq():
    """At S = 1 the residual's ``tp_seq`` does not divide over the model
    axis: it replicates (the rules' divisibility fallback), as the
    reference's ``LogicalRules`` resolves it, and a prompt of 12 splits."""
    rules, mesh = LogicalRules(), StackedMesh((2, 4), ("data", "model"))
    assert rules.spec(("batch", "tp_seq", "embed"), (8, 1, 64), mesh) == (
        "data", None, None)
    assert rules.spec(("batch", "tp_seq", "embed"), (8, 12, 64), mesh) == (
        "data", "model", None)


# ---------------------------------------------------------------------------
# over gloo processes
# ---------------------------------------------------------------------------

def _gloo_rank(rank, world, store_path, out_path, params, inputs):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_mesh((1, 4), ("data", "model"))
        out = _serve(_cfg("llama"), params, inputs, mesh)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def test_gloo_4_process_serving_matches_the_stacked_run(ref, one_thread,
                                                        tmp_path):
    """Each process one rank of a (1, 4) ``DeviceMesh`` (the collectives
    over gloo, the cache gathered rank by rank): the stacked run's tokens,
    logits, caches and ``pos`` bit for bit, and its bytes a rank."""
    want = _serve(_cfg("llama"), _params(ref, "llama"), _inputs("llama"),
                  StackedMesh((1, 4), ("data", "model")))
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "out")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, 4, str(tmp_path / "store"), out,
                               _params(ref, "llama"), _inputs("llama")))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * 4
    got = torch.load(out, weights_only=False)
    assert got["held_bytes"] == want["held_bytes"][:1]
    for k in want:
        if k != "held_bytes":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
