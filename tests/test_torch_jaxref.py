"""The JAX package as a live oracle for the PyTorch port's tests.

The reference never runs inside the pytest worker.  :func:`run_reference`
starts ONE child process per call (the port's test modules call it once, from
a module-scoped fixture), hands it an ``.npz`` of inputs and a list of jobs,
and reads back an ``.npz`` of outputs.  The child is this same file run as a
script: it sets ``jax.core.{Primitive, Jaxpr, ClosedJaxpr, Literal, Var}``
to their ``jax.extend.core`` namesakes (the installed JAX no longer has the
former, which ``repro.core.tagging`` and ``repro.analysis.flow`` use),
then imports ``repro.*`` and runs the jobs below — Pallas kernels in
interpret mode or through ``repro.kernels.ref``, as the JAX package's own
tests run them on the CPU.

Why a child: a worker that imported ``repro.core.tagging`` through the shim
would make JAX test files that run later in the same worker behave
differently from a worker that did not.

It also holds the ``one_thread`` fixture of the port's bit-for-bit CPU
tests.  Importing this module imports neither ``jax`` nor ``repro``.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_NAMES = ("count", "nonzero", "overflow", "abs_err_sum", "rel_err_sum",
              "abs_sum", "max_abs")


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

def run_reference(jobs, arrays=None, timeout=900, host_devices=None,
                  fast_codegen=False):
    """Run ``jobs`` in one child process against the JAX package.

    ``jobs``: list of ``{"job": <name of a job_* function below>, "tag":
    <prefix>, "kw": {json-able keyword arguments}}``.  ``arrays``: dict of
    numpy arrays keyed ``"<tag>/<name>"``; a job sees those under its tag
    with the prefix stripped.  Returns the outputs keyed the same way.
    ``host_devices``: the child forces that many CPU devices
    (``--xla_force_host_platform_device_count``), for jobs that run the
    reference's collectives under ``shard_map``.  ``fast_codegen``: XLA's
    CPU code generation at its lowest optimization level, for jobs that
    read compiled HLO rather than run it at speed (the HLO passes are
    unchanged).
    """
    arrays = dict(arrays or {})
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(fin, __jobs__=np.array(json.dumps(jobs)), **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(REPO, "src"))
        env.pop("XLA_FLAGS", None)
        flags = []
        if host_devices:
            flags.append("--xla_force_host_platform_device_count="
                         f"{int(host_devices)}")
        if fast_codegen:
            flags += ["--xla_backend_optimization_level=0",
                      "--xla_llvm_disable_expensive_passes=true"]
        if flags:
            env["XLA_FLAGS"] = " ".join(flags)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              fin, fout], capture_output=True, text=True,
                             env=env, cwd=REPO, timeout=timeout)
        if out.returncode:
            raise RuntimeError("reference child failed:\n"
                               + out.stdout[-2000:] + out.stderr[-4000:])
        with np.load(fout) as z:
            return {k: z[k] for k in z.files}


def flatten(tree, prefix=""):
    """Nested dict of arrays -> flat ``{"a/b/c": array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat, prefix):
    """Inverse of :func:`flatten` for the keys under ``prefix``."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.fixture
def one_thread():
    """Both runs of a bit-for-bit comparison of the smoke LM on one CPU
    thread: with several, the math libraries may split a product's sums
    by the threads they take, and a busy machine (parallel test workers)
    changes that between runs — an ulp in one activation can move a
    stochastic tap across a grid step.  A test module takes it by
    importing it from here."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def test_reference_imports_and_serves_through_the_shim():
    """The oracle itself: with the shim the reference imports and its
    serving CLI smoke-runs, so a JAX bump that breaks it shows here."""
    out = run_reference([{"job": "serve_cli", "tag": "cli", "kw": {}}])
    assert int(out["cli/total_tokens"]) > 0
    assert int(out["cli/spread_rows"]) > 0


# ---------------------------------------------------------------------------
# child side: everything below runs only in the child process
# ---------------------------------------------------------------------------

def _stats_out(s):
    return {n: np.asarray(getattr(s, n), np.float32) for n in STAT_NAMES}


def _smoke_cfg(arch="llama3_2_3b", overrides=None):
    """``arch``'s smoke config, with ``overrides`` (a dict of fields) on
    top: a head geometry or a ``train_accum`` that ``smoke`` flattens."""
    import dataclasses
    from repro.configs.base import get_config, smoke
    return dataclasses.replace(smoke(get_config(arch)), **(overrides or {}))


def _layout(kw):
    from repro.serve import PagedLayout
    return PagedLayout(**kw)


def _np_params(params):
    import jax
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def job_quantize(a, wire, mode, compute_stats=True):
    import jax.numpy as jnp
    from repro.core import fixed_point as fxp
    fmt = fxp.FixedPointFormat(jnp.asarray(a["il"], jnp.int32),
                               jnp.asarray(a["fl"], jnp.int32))
    bits = jnp.asarray(a["bits"]) if "bits" in a else None
    x = jnp.asarray(a["x"])
    if wire:
        mask = jnp.asarray(a["mask"]) if "mask" in a else None
        q, s = fxp.wire_quantize(x, fmt, mode=mode, bits=bits, mask=mask,
                                 compute_stats=compute_stats)
    else:
        q, s = fxp.quantize(x, fmt, mode=mode, bits=bits,
                            compute_stats=compute_stats)
    out = {"q": np.asarray(q)}
    if s is not None:
        out.update(_stats_out(s))
    return out


def job_flexpoint(a, hyper, wire=None):
    """Drive FlexpointController.update over a [T, G] sequence of stats."""
    import jax.numpy as jnp
    from repro.core import dps
    from repro.core.fixed_point import QuantStats
    h = dps.wire_hyper(**wire) if wire else dps.DPSHyper(**hyper)
    ctrl = dps.make_controller("flexpoint", h)
    T, G = a["max_abs"].shape
    st = ctrl.init((G,))
    ils, fls, emas = [np.asarray(st.il)], [np.asarray(st.fl)], \
        [np.asarray(st.max_ema)]
    z = jnp.zeros((G,), jnp.float32)
    for t in range(T):
        stats = QuantStats(count=z + 1, nonzero=jnp.asarray(a["nonzero"][t]),
                           overflow=z, abs_err_sum=z, rel_err_sum=z,
                           abs_sum=jnp.asarray(a["abs_sum"][t]),
                           max_abs=jnp.asarray(a["max_abs"][t]))
        st = ctrl.update(st, stats)
        ils.append(np.asarray(st.il))
        fls.append(np.asarray(st.fl))
        emas.append(np.asarray(st.max_ema))
    return {"il": np.stack(ils), "fl": np.stack(fls), "max_ema": np.stack(emas)}


def job_ceil_log2(a):
    """``ceil(log2(x))`` as the reference's float32 arithmetic gives it."""
    import jax.numpy as jnp
    return {"ceil": np.asarray(jnp.ceil(jnp.log2(jnp.asarray(a["x"]))),
                               np.int32)}


def job_kv_plan_init(a, layout, il_init):
    from repro.serve import cache as kvc
    cfg, lay = _smoke_cfg(), _layout(layout)
    st = kvc.kv_plan(cfg, lay, il_init).init()[kvc.KV_DOMAIN]
    return {"il": np.asarray(st.il), "fl": np.asarray(st.fl),
            "max_ema": np.asarray(st.max_ema)}


def job_group_encode(a, quantum, stochastic, pallas):
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.dps_quant import dps_quant_group_wire_pallas
    mode = "stochastic" if stochastic else "nearest"
    x, mask = jnp.asarray(a["x"]), jnp.asarray(a["mask"])
    bits = jnp.asarray(a["bits"])
    wire, stats = ref.dps_quant_group_wire_ref(
        x, a["il"], a["fl"], a["tile_group"], bits if stochastic else None,
        mask, quantum, mode=mode)
    out = {"ref_wire": np.asarray(wire), "ref_stats": np.asarray(stats)}
    if pallas:
        fmt_tab = jnp.stack([jnp.asarray(a["il"], jnp.int32),
                             jnp.asarray(a["fl"], jnp.int32)], axis=1)
        tg = jnp.asarray(a["tile_group"], jnp.int32)
        seed = jnp.zeros((1,), jnp.int32)
        w, s = dps_quant_group_wire_pallas(
            x, fmt_tab, tg, seed, bits, mask, stochastic=stochastic,
            quantum=quantum, interpret=True, emit_stats=True)
        w2, s2 = dps_quant_group_wire_pallas(
            x, fmt_tab, tg, seed, bits, mask, stochastic=stochastic,
            quantum=quantum, interpret=True, emit_stats=False)
        assert s2 is None
        out.update(pallas_wire=np.asarray(w), pallas_stats=np.asarray(s),
                   pallas_wire_nostats=np.asarray(w2))
    return out


def job_paged_attn(a, scale):
    import jax.numpy as jnp
    from repro.kernels.ref import paged_decode_attn_ref
    out = paged_decode_attn_ref(
        jnp.asarray(a["q"]), jnp.asarray(a["kp"]), jnp.asarray(a["vp"]),
        jnp.asarray(a["fmt"]), jnp.asarray(a["ptab"]), jnp.asarray(a["lens"]),
        scale=scale)
    return {"out": np.asarray(out)}


def job_write_pages(a, layout, bits, n_writes, reset_pages):
    """A sequence of write_prompt_pages calls on shared ck/cv/phys/plen,
    then reset_rows over the rows of ``reset_pages`` and fmt_tables."""
    import jax.numpy as jnp
    from repro.serve import cache as kvc
    from repro.serve.page_table import page_rows
    cfg, lay = _smoke_cfg(), _layout(layout)
    plan = kvc.kv_plan(cfg, lay) if bits == 8 else None
    pools = kvc.init_pool(cfg, lay, bits)
    state = plan.init()[kvc.KV_DOMAIN] if bits == 8 else None
    for i in range(n_writes):
        pools, state = kvc.write_prompt_pages(
            cfg, lay, plan, pools, state, jnp.asarray(a[f"ck{i}"]),
            jnp.asarray(a[f"cv{i}"]), jnp.asarray(a[f"phys{i}"]),
            jnp.int32(int(a[f"plen{i}"])), bits=bits, encode_backend="jnp")
    out = {"k_pages": np.asarray(pools.k_pages),
           "v_pages": np.asarray(pools.v_pages)}
    if bits == 8:
        out.update(il=np.asarray(state.il), fl=np.asarray(state.fl),
                   max_ema=np.asarray(state.max_ema))
        k_fmt, v_fmt = kvc.fmt_tables(state, cfg, lay)
        out.update(k_fmt=np.asarray(k_fmt), v_fmt=np.asarray(v_fmt))
        mask = np.zeros(kvc.n_rows(cfg, lay), bool)
        mask[page_rows(cfg.n_layers, lay.n_pages_total,
                       reset_pages).reshape(-1)] = True
        st2 = kvc.reset_rows(plan, state, jnp.asarray(mask))
        out.update(reset_il=np.asarray(st2.il), reset_fl=np.asarray(st2.fl),
                   reset_max_ema=np.asarray(st2.max_ema))
    return out


def _smoke_params(seed, arch="llama3_2_3b", overrides=None):
    import jax
    from repro.models import registry
    from repro.models.common import init_params
    cfg = _smoke_cfg(arch, overrides)
    mod = registry(cfg.family)
    return cfg, mod, init_params(jax.random.key(seed), mod.model_defs(cfg))


def job_model(a, seed, layout, arch="llama3_2_3b", overrides=None):
    """Smoke params plus prefill logits, contiguous decode logits and one
    paged decode step on shared pools.  A ``vision_embeds`` array, if the
    test hands one over, is the prompt's vision prefix."""
    import jax.numpy as jnp
    cfg, mod, params = _smoke_params(seed, arch, overrides)
    out = flatten(_np_params(params), "params/")
    toks = jnp.asarray(a["tokens"])
    vis = a.get("vision_embeds")
    vis = None if vis is None else jnp.asarray(vis)
    max_seq = toks.shape[1] + (0 if vis is None else vis.shape[1]) + 4
    logits, cache, pos = mod.prefill(cfg, params, toks, max_seq,
                                     vision_embeds=vis)
    out.update(prefill_logits=np.asarray(logits),
               prefill_ck=np.asarray(cache[0]), prefill_cv=np.asarray(cache[1]))
    lg, cache = mod.decode_step(cfg, params, jnp.asarray(a["next"]), cache, pos)
    out["decode_logits"] = np.asarray(lg)
    # paged step on pools handed over by the test
    pcache = tuple(jnp.asarray(a[k]) for k in ("k_pages", "v_pages", "k_fmt",
                                                "v_fmt"))
    lg, new = mod.decode_step_paged(cfg, params, jnp.asarray(a["ptoks"]),
                                    pcache, jnp.asarray(a["ptab"]),
                                    jnp.asarray(a["ppos"]), backend="jnp")
    out.update(paged_logits=np.asarray(lg), paged_k=np.asarray(new[0]),
               paged_v=np.asarray(new[1]))
    return out


def job_engine(a, seed, layout, traces, arch="llama3_2_3b", overrides=None):
    """The reference Engine over synthetic traces, kv_bits 8 and None."""
    from repro.serve import Engine, EngineConfig, synthetic_trace
    cfg, mod, params = _smoke_params(seed, arch, overrides)
    lay = _layout(layout)
    out = flatten(_np_params(params), "params/")
    for name, tr in traces.items():
        reqs = synthetic_trace(tr["n"], cfg.vocab,
                               prompt_lens=tuple(tr["prompt_lens"]),
                               new_tokens=tuple(tr["new_tokens"]),
                               mean_gap=tr["mean_gap"], seed=tr["seed"])
        eng = Engine(cfg, params, EngineConfig(
            layout=lay, kv_bits=tr["kv_bits"], attn_backend="jnp",
            encode_backend="jnp"))
        rep = eng.run(reqs)
        for r in reqs:
            out[f"{name}/tokens/{r.rid}"] = np.asarray(rep.tokens[r.rid],
                                                       np.int32)
        out[f"{name}/spread"] = np.array(json.dumps(rep.format_spread))
    return out


def job_config(a, archs):
    """Each of ``archs``' reference config: its fields as JSON and its
    analytic ``n_params()`` at full size."""
    import dataclasses
    from repro.configs.base import get_config
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        out[f"{arch}/fields"] = np.array(json.dumps(dataclasses.asdict(cfg)))
        out[f"{arch}/n_params"] = np.float64(cfg.n_params())
        out[f"{arch}/n_active_params"] = np.float64(cfg.n_active_params())
    return out


def job_serve_refusal(a, arch):
    """The message with which the reference's serving CLI refuses
    ``arch`` at smoke size (``SystemExit``); empty if it serves it."""
    from repro.launch import serve
    try:
        serve.main(["--arch", arch, "--smoke", "--requests", "1"])
    except SystemExit as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def job_serve_cli(a):
    from repro.launch import serve
    rep = serve.main(["--arch", "llama3_2_3b", "--smoke", "--requests", "4",
                      "--slots", "2", "--page-size", "4", "--max-prompt", "8",
                      "--max-new", "6"])
    return {"total_tokens": np.int64(rep.metrics["total_tokens"]),
            "spread_rows": np.int64(sum(rep.format_spread.values()))}


def job_quant_ops(a, cases):
    """``repro.kernels.ops.dps_quantize`` (the Pallas kernel in interpret
    mode) on shared bits, one entry of ``cases`` per input."""
    import jax.numpy as jnp
    from repro.core.fixed_point import FixedPointFormat
    from repro.kernels import ops
    out = {}
    for name, c in cases.items():
        x = jnp.asarray(a[f"{name}/x"])
        if c.get("bf16"):
            x = x.astype(jnp.bfloat16)
        bits = jnp.asarray(a[f"{name}/bits"]) if c["stochastic"] else None
        q, s = ops.dps_quantize(x, FixedPointFormat.create(c["il"], c["fl"]),
                                bits=bits, stochastic=c["stochastic"],
                                interpret=True)
        out[f"{name}/q"] = np.asarray(q.astype(jnp.float32))
        out.update({f"{name}/{k}": v for k, v in _stats_out(s).items()})
    return out


def job_quantize_tree(a, seed, il, fl):
    """``fixed_point.quantize_tree`` under the default policy, nearest."""
    from repro.core import fixed_point as fxp
    from repro.core.policy import QuantPolicy
    cfg, mod, params = _smoke_params(seed)
    q, s = fxp.quantize_tree(params, fxp.FixedPointFormat.create(il, fl),
                             mode="nearest",
                             predicate=QuantPolicy().param_predicate())
    out = flatten(_np_params(params), "params/")
    out.update(flatten(_np_params(q), "q/"))
    out.update({f"stats/{k}": v for k, v in _stats_out(s).items()})
    return out


def job_qtap(a, acts, grads, salt):
    """``QCtx.tap`` forward (q, stats) and its custom-vjp backward, nearest."""
    import jax
    import jax.numpy as jnp
    from repro.core import qtrain
    from repro.core.fixed_point import FixedPointFormat
    qctx = qtrain.QCtx(acts_fmt=FixedPointFormat.create(*acts),
                       grads_fmt=FixedPointFormat.create(*grads),
                       key=jax.random.key(0), rounding="nearest",
                       collect_stats=True)
    x = jnp.asarray(a["x"])
    q, s = qctx.tap(x, salt)
    _, vjp = jax.vjp(lambda v: qctx.tap(v, salt)[0], x)
    (g,) = vjp(jnp.asarray(a["cot"]))
    out = {"q": np.asarray(q), "g": np.asarray(g)}
    out.update(_stats_out(s))
    return out


def job_controllers(a, names, hyper):
    """Each controller driven over one shared [T] stats/loss sequence."""
    import jax.numpy as jnp
    from repro.core import dps
    from repro.core.fixed_point import QuantStats
    out = {}
    for name in names:
        ctrl = dps.make_controller(name, dps.DPSHyper(**hyper))
        st = ctrl.init()
        ils, fls = [np.asarray(st.il)], [np.asarray(st.fl)]
        for t in range(a["count"].shape[0]):
            stats = QuantStats(*(jnp.asarray(a[k][t]) for k in STAT_NAMES))
            st = ctrl.update(st, stats, {"loss": jnp.asarray(a["loss"][t])})
            ils.append(np.asarray(st.il))
            fls.append(np.asarray(st.fl))
        out[f"{name}/il"], out[f"{name}/fl"] = np.stack(ils), np.stack(fls)
    return out


def job_optim(a, kind, steps, kw):
    """``steps`` replicated optimizer updates; params after each."""
    import jax
    import jax.numpy as jnp
    from repro.optim import AdamWConfig, SGDConfig, make_optimizer
    opt = make_optimizer(SGDConfig(**kw) if kind == "sgd"
                         else AdamWConfig(**kw))
    params = jax.tree.map(jnp.asarray, unflatten(a, "params/"))
    state = opt.init(params)
    out = {}
    for t in range(steps):
        grads = jax.tree.map(jnp.asarray, unflatten(a, f"grads{t}/"))
        upd, state = opt.update(grads, state, params, count=jnp.int32(t))
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        out.update(flatten(_np_params(params), f"p{t}/"))
        out[f"lr{t}"] = np.asarray(opt.sched(jnp.int32(t)), np.float32)
    return out


def _run_train(step_fn, state, batches, names=("loss", "il_w", "fl_w",
                                                "il_a", "fl_a", "il_g",
                                                "fl_g", "E_a", "R_a", "E_g",
                                                "E_w")):
    hist = {k: [] for k in names}
    for b in batches:
        state, m = step_fn(state, b)
        for k in names:
            hist[k].append(float(m[k]))
    return state, {k: np.asarray(v, np.float64) for k, v in hist.items()}


def job_lenet_train(a, steps, n_train, qkw=None):
    """LeNet from ``lenet.init(key(0))``: ``steps`` paper-controller steps
    under nearest rounding on ``MNISTLike(n_train=...)``; ``qkw`` goes to
    ``paper_quant_config``."""
    import jax
    from repro.apps.mnist import paper_quant_config
    from repro.core import qtrain
    from repro.data import MNISTLike
    from repro.models import lenet
    from repro.optim import SGDConfig, make_optimizer
    params = lenet.init(jax.random.key(0))
    out = flatten(_np_params(params), "params/")
    qcfg = paper_quant_config(rounding="nearest", **(qkw or {}))
    opt = make_optimizer(SGDConfig())
    step_fn = jax.jit(qtrain.make_train_step(lenet.loss_fn, opt, qcfg))
    state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                     jax.random.key(1))
    data = MNISTLike(batch=64, seed=0, n_train=n_train, n_test=64)
    _, hist = _run_train(step_fn, state,
                         [data.train_batch(i) for i in range(steps)])
    out.update({f"hist/{k}": v for k, v in hist.items()})
    return out


def job_paper_config(a, cases):
    """``paper_quant_config(**kw)`` for each of ``cases`` (a dict of name
    -> keyword arguments): the controller, rounding, statistics scope and
    each domain's ``DPSHyper`` fields, as JSON."""
    import dataclasses
    from repro.apps.mnist import paper_quant_config
    out = {}
    for name, kw in cases.items():
        q = paper_quant_config(**kw)
        out[name] = np.array(json.dumps({
            "enabled": q.enabled, "controller": q.controller,
            "rounding": q.rounding, "stat_scope": q.stat_scope,
            **{h: dataclasses.asdict(getattr(q, h)) for h in
               ("hyper_weights", "hyper_acts", "hyper_grads")}}))
    return out


def job_mla_model(a, seed, max_seq):
    """Smoke deepseek-v2 (MLA) from ``init_params(key(seed))``, once for
    each latent-cache width (``kv_cache_bits`` 16 and 8): the prefill
    logits and latent caches, then one absorbed decode step for each
    column of ``steps`` (B, n), its logits and the caches after it."""
    import jax.numpy as jnp
    _, mod, params = _smoke_params(seed, "deepseek_v2_236b")
    out = flatten(_np_params(params), "params/")
    for bits in (16, 8):
        cfg = _smoke_cfg("deepseek_v2_236b", {"kv_cache_bits": bits})
        logits, cache, pos = mod.prefill(cfg, params, jnp.asarray(a["tokens"]),
                                         max_seq)
        out[f"{bits}/prefill_logits"] = np.asarray(logits)
        out[f"{bits}/prefill_cc"] = np.asarray(cache[0])
        out[f"{bits}/prefill_cr"] = np.asarray(cache[1])
        for i in range(a["steps"].shape[1]):
            lg, cache = mod.decode_step(cfg, params,
                                        jnp.asarray(a["steps"][:, i:i + 1]),
                                        cache, pos)
            pos = pos + 1
            out[f"{bits}/decode_logits/{i}"] = np.asarray(lg)
        out[f"{bits}/decode_cc"] = np.asarray(cache[0])
        out[f"{bits}/decode_cr"] = np.asarray(cache[1])
    return out


def _cache_np(cache):
    """A decode cache (tuples and dicts of arrays) as a flat dict of numpy
    arrays, a tuple's entries keyed by their index."""
    if isinstance(cache, (tuple, list)):
        cache = {str(i): c for i, c in enumerate(cache)}
    if isinstance(cache, dict):
        return {f"{k}/{n}" if n else k: v for k, c in cache.items()
                for n, v in _cache_np(c).items()}
    return {"": np.asarray(cache, np.float32)}


def job_decode_model(a, seed, arch, max_seq, overrides=None, bits=(16,)):
    """Smoke ``arch`` (any family) from ``init_params(key(seed))``, once for
    each ``kv_cache_bits`` in ``bits``: the prefill logits and cache (a
    ``frames`` array, if handed over, is an encoder-decoder's input), then
    one ``decode_step`` for each column of ``steps`` (B, n), its logits,
    and the cache after them."""
    import jax.numpy as jnp
    _, mod, params = _smoke_params(seed, arch, overrides)
    out = flatten(_np_params(params), "params/")
    kw = {"frames": jnp.asarray(a["frames"])} if "frames" in a else {}
    for b in bits:
        cfg = _smoke_cfg(arch, dict(overrides or {}, kv_cache_bits=b))
        logits, cache, pos = mod.prefill(cfg, params, jnp.asarray(a["tokens"]),
                                         max_seq, **kw)
        out[f"{b}/prefill_logits"] = np.asarray(logits)
        out.update(flatten(_cache_np(cache), f"{b}/prefill_cache/"))
        for i in range(a["steps"].shape[1]):
            lg, cache = mod.decode_step(cfg, params,
                                        jnp.asarray(a["steps"][:, i:i + 1]),
                                        cache, pos)
            pos = pos + 1
            out[f"{b}/decode_logits/{i}"] = np.asarray(lg)
        out.update(flatten(_cache_np(cache), f"{b}/decode_cache/"))
    return out


def job_bf16_drift(a, seed, arch, max_seq, overrides=None):
    """Smoke ``arch`` from ``init_params(key(seed))`` at the bf16 working
    dtype (its fp32 islands fp32), then the same weights cast up to fp32:
    under each, the prefill logits of ``tokens`` and one ``decode_step`` on
    ``step`` (a ``frames`` array, if handed over, is an encoder-decoder's
    input)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    cfg, mod, params = _smoke_params(seed, arch,
                                     dict(overrides or {}, dtype="bfloat16"))
    out = flatten(_np_params(params), "params/")
    kw = {"frames": jnp.asarray(a["frames"])} if "frames" in a else {}
    up = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    for name, c, p in (("bfloat16", cfg, params),
                       ("float32", dataclasses.replace(cfg, dtype="float32"),
                        up)):
        logits, cache, pos = mod.prefill(c, p, jnp.asarray(a["tokens"]),
                                         max_seq, **kw)
        lg, _ = mod.decode_step(c, p, jnp.asarray(a["step"]), cache, pos)
        out[f"{name}/prefill_logits"] = np.asarray(logits, np.float32)
        out[f"{name}/decode_logits"] = np.asarray(lg, np.float32)
    return out


def job_ssm(a, overrides, n_prompt):
    """The reference's SSD pieces at smoke width (``overrides`` on the
    mamba2 smoke config): ``ssd_scan`` on x, b, c, dt, log_decay without
    and with ``h0``; ``_causal_conv`` without and with the ``tail``;
    ``ssm_apply`` with the ``p/*`` parameters on ``u`` in train mode, in
    prefill on the first ``n_prompt`` positions and in decode on the next;
    and ``ssm_apply`` in train mode at the configs' own chunk and
    initialization on ``u256`` (``init_params(key(0))``, which the port
    gets back as ``init/*``)."""
    import jax.numpy as jnp
    from repro.models import ssm
    from repro.models.common import init_params
    import jax
    cfg = _smoke_cfg("mamba2_1_3b", overrides)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    out = {}
    for name, h0 in (("scan", None), ("scan_h0", j["h0"])):
        y, h = ssm.ssd_scan(cfg, j["x"], j["b"], j["c"], j["dt"], j["ld"], h0)
        out[f"{name}/y"], out[f"{name}/h"] = np.asarray(y), np.asarray(h)
    for name, tail in (("conv", None), ("conv_tail", j["tail"])):
        y, st = ssm._causal_conv(j["xbc"], j["w"], j["cb"], tail)
        out[f"{name}/y"], out[f"{name}/state"] = np.asarray(y), np.asarray(st)
    p = unflatten(j, "p/")
    u, n = j["u"], n_prompt
    y, _ = ssm.ssm_apply(cfg, p, u, mode="train")
    out["train/y"] = np.asarray(y)
    y, cache = ssm.ssm_apply(cfg, p, u[:, :n], mode="prefill")
    out["prefill/y"] = np.asarray(y)
    out["prefill/h"], out["prefill/tail"] = map(np.asarray, cache)
    y, cache = ssm.ssm_apply(cfg, p, u[:, n:n + 1], mode="decode", cache=cache)
    out["decode/y"] = np.asarray(y)
    out["decode/h"], out["decode/tail"] = map(np.asarray, cache)
    cfg256 = _smoke_cfg("mamba2_1_3b", {"ssm_chunk": 256})
    p0 = init_params(jax.random.key(0), ssm.ssm_defs(cfg256, jnp.float32))
    y, _ = ssm.ssm_apply(cfg256, p0, j["u256"], mode="train")
    out["chunk256/y"] = np.asarray(y)
    out.update(flatten(_np_params(p0), "init/"))
    return out


def job_cross_attn(a):
    """The reference's ``gqa_apply`` at whisper's smoke geometry with the
    ``p/*`` parameters: cross-attention from ``x`` (B, Sq, D) over ``kv_x``
    (B, Sk, D) in train and prefill mode (the prefill's cross K/V at
    ``kv_cache_bits`` 16 and 8), and ``decode_static`` of ``x1`` (B, 1, D)
    over the fp32 (``ck``, ``cv``) and int8 (``ck8``, ``cv8``) caches."""
    import jax.numpy as jnp
    from repro.models import attention
    j = {k: jnp.asarray(v) for k, v in a.items()}
    p = unflatten(j, "p/")
    x, kv_x = j["x"], j["kv_x"]
    positions = jnp.arange(x.shape[1], dtype=jnp.int32)[None, :]
    out = {}
    for bits in (16, 8):
        cfg = _smoke_cfg("whisper_medium", {"kv_cache_bits": bits})
        o, _ = attention.gqa_apply(cfg, p, x, positions=positions,
                                   mode="train", kv_x=kv_x, causal=False)
        out[f"{bits}/train"] = np.asarray(o)
        o, (ck, cv) = attention.gqa_apply(cfg, p, x, positions=positions,
                                          mode="prefill", kv_x=kv_x,
                                          causal=False)
        out[f"{bits}/prefill"] = np.asarray(o)
        out[f"{bits}/ck"] = np.asarray(ck, np.float32)
        out[f"{bits}/cv"] = np.asarray(cv, np.float32)
    cfg = _smoke_cfg("whisper_medium")
    at = jnp.full((x.shape[0], 1), 5, jnp.int32)
    for name, cache in (("static", (j["ck"], j["cv"])),
                        ("static8", (j["ck8"].astype(jnp.int8),
                                     j["cv8"].astype(jnp.int8)))):
        o, _ = attention.gqa_apply(cfg, p, j["x1"], positions=at,
                                   mode="decode_static", cache=cache)
        out[name] = np.asarray(o)
    return out


def job_lm_train(a, steps, seq, batch, remat, arch="llama3_2_3b",
                 overrides=None, flash_block=None):
    """Smoke ``arch`` (llama3.2-3b by default) from ``init_params(key(0))``:
    ``steps`` SGD steps under nearest rounding on the synthetic token
    stream, over the config's ``train_accum`` microbatches.  A
    ``vision_embeds`` array from the test rides on every batch (a VLM's
    prefix), and so does a ``frames`` array (an encoder-decoder's frame
    embeddings).  ``flash_block``: attention goes blockwise at every
    length, in blocks of that many positions."""
    import dataclasses
    import jax
    if flash_block:
        _flash_everywhere(flash_block)
    from repro.core import qtrain
    from repro.data import TokenStream, TokenStreamConfig
    from repro.models import registry
    from repro.models.common import init_params
    from repro.optim import SGDConfig, make_optimizer
    cfg = dataclasses.replace(_smoke_cfg(arch, overrides), remat=remat)
    mod = registry(cfg.family)
    params = init_params(jax.random.key(0), mod.model_defs(cfg))
    out = flatten(_np_params(params), "params/")
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step_fn = jax.jit(qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg,
                                             accum_steps=cfg.train_accum))
    state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                     jax.random.key(1))
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch, seed=0))
    extras = {k: jax.numpy.asarray(a[k]) for k in ("vision_embeds", "frames")
              if k in a}
    _, hist = _run_train(step_fn, state,
                         [dict(data.batch(i), **extras) for i in range(steps)])
    out.update({f"hist/{k}": v for k, v in hist.items()})
    return out


def _flash_everywhere(block):
    """The reference's ``sdpa`` goes blockwise at every length, in blocks
    of ``block`` positions."""
    from functools import partial
    from repro.models import attention
    attention.FLASH_THRESHOLD = 0
    attention._attn_flash = partial(attention._attn_flash, block=block)


def job_moe(a, seed, arch, overrides=None):
    """The reference's MoE layer at smoke size on ``x`` (B, S, D): the
    router's top-k indices and weights, each choice's capacity slot and
    keep flag (the lines of ``_moe_einsum`` that make them), and
    ``moe_apply``'s output and auxiliary loss."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe
    from repro.models.common import init_params
    cfg = _smoke_cfg(arch, overrides)
    p = init_params(jax.random.key(seed), moe.moe_defs(cfg, jnp.float32))
    x = jnp.asarray(a["x"])
    x2 = x.reshape(-1, x.shape[-1])
    T = x2.shape[0]
    top_w, top_i, probs = moe._router(cfg, p["router"], x2)
    onehot = jax.nn.one_hot(top_i, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(T * cfg.top_k, cfg.n_experts)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(T, cfg.top_k)
    y, aux = moe.moe_apply(cfg, p, x)
    out = flatten(_np_params(p), "params/")
    out.update(top_i=np.asarray(top_i), top_w=np.asarray(top_w),
               probs=np.asarray(probs), pos=np.asarray(pos),
               keep=np.asarray(pos < moe._capacity(T, cfg)),
               capacity=np.int64(moe._capacity(T, cfg)), y=np.asarray(y),
               aux=np.asarray(aux))
    return out


def job_flash(a, block, causal):
    """The reference's ``_attn_flash`` (blocks of ``block``) and
    ``_attn_full`` on q, k, v, and the gradients of ``sum(out * w)`` with
    respect to q, k and v through each."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention
    q, k, v, w = (jnp.asarray(a[n]) for n in ("q", "k", "v", "w"))
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    out = {}
    for name, fn in (("flash", lambda *t: attention._attn_flash(
                          *t, causal=causal, scale=scale, block=block)),
                     ("full", lambda *t: attention._attn_full(
                          *t, causal=causal, scale=scale))):
        o = fn(q, k, v)
        g = jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * w),
                     argnums=(0, 1, 2))(q, k, v)
        out[f"{name}/out"] = np.asarray(o)
        for n, t in zip("qkv", g):
            out[f"{name}/d{n}"] = np.asarray(t)
    return out


def job_long(a, seed):
    """Smoke llama3.2-3b on one long sequence, through the reference's
    ``sdpa`` at its real threshold: prefill logits, and the loss and its
    gradients (no quantization) on ``tokens`` with the last as labels."""
    import jax
    import jax.numpy as jnp
    cfg, mod, params = _smoke_params(seed)
    toks = jnp.asarray(a["tokens"])
    logits, _, _ = mod.prefill(cfg, params, toks[:, :-1], toks.shape[1] - 1)
    loss, g = jax.value_and_grad(
        lambda p: mod.loss_fn(cfg)(p, {"tokens": toks})[0])(params)
    out = flatten(_np_params(params), "params/")
    out.update(flatten(_np_params(g), "grads/"))
    out.update(prefill_logits=np.asarray(logits), loss=np.asarray(loss))
    return out


def _fmt(a, prefix=""):
    import jax.numpy as jnp
    from repro.core.fixed_point import FixedPointFormat
    return FixedPointFormat(jnp.asarray(a[prefix + "il"], jnp.int32),
                            jnp.asarray(a[prefix + "fl"], jnp.int32))


def job_wire_codec(a, cases):
    """``collectives.wire_encode``/``wire_decode`` (the jnp codec) and the
    kernels' oracles ``ref.dps_quant_wire_ref`` / ``dps_wire_reduce_ref``,
    one entry of ``cases`` per input."""
    import jax
    import jax.numpy as jnp
    from repro.dist import collectives as coll
    from repro.kernels import ref
    out = {}
    for name, c in cases.items():
        p = f"{name}/"
        if c.get("kind") == "reduce":
            # the oracle takes whole tiles: a ragged last tile is zero-padded
            # and the padding's means cut off again
            wire = a[p + "wire"]
            chunk, q = wire.shape[1], c["quantum"]
            pad = -(-chunk // q) * q - chunk
            m = ref.dps_wire_reduce_ref(jnp.asarray(np.pad(wire, ((0, 0),
                                                                  (0, pad)))),
                                        jnp.asarray(a[p + "fl"]),
                                        jnp.asarray(a[p + "tile_group"]), q)
            out[p + "mean"] = np.asarray(m)[:chunk]
            continue
        x = jnp.asarray(a[p + "x"])
        if c.get("bf16"):
            x = x.astype(jnp.bfloat16)
        bits = jnp.asarray(a[p + "bits"]) if c["mode"] == "stochastic" else None
        fmt = _fmt(a, p)
        gs = tuple(c["group_sizes"]) if c.get("group_sizes") else None
        if c.get("traced"):
            # a traced format is not checked for capacity: it saturates
            f = jax.jit(lambda x, b, il, fl: coll.wire_encode(
                x, coll.FixedPointFormat(il, fl), bits=b, mode=c["mode"],
                backend="jnp", group_sizes=gs))
            w, s = f(x, bits, fmt.il, fmt.fl)
        else:
            w, s = coll.wire_encode(x, fmt, bits=bits, mode=c["mode"],
                                    backend="jnp", group_sizes=gs)
        out[p + "wire"] = np.asarray(w)
        out.update({p + k: v for k, v in _stats_out(s).items()})
        out[p + "decoded"] = np.asarray(coll.wire_decode(w, fmt,
                                                         group_sizes=gs))
        if fmt.il.ndim == 0:
            w2, v = ref.dps_quant_wire_ref(
                x, fmt.il, fmt.fl,
                bits if bits is not None else jnp.zeros(x.shape, jnp.uint32),
                mode=c["mode"])
            out[p + "ref_wire"] = np.asarray(w2)
            out[p + "ref_vec"] = np.asarray(v)
    return out


def job_wire_reduce_pallas(a, names, quantum):
    """K4's reference, ``dps_wire_reduce_pallas`` in interpret mode, on each
    named ``wire`` / ``fmt_tab`` / ``tile_group``."""
    import jax.numpy as jnp
    from repro.kernels.dps_quant import dps_wire_reduce_pallas
    out = {}
    for name in names:
        p = f"{name}/"
        out[p + "mean"] = np.asarray(dps_wire_reduce_pallas(
            jnp.asarray(a[p + "wire"]), jnp.asarray(a[p + "fmt_tab"]),
            jnp.asarray(a[p + "tile_group"]), quantum=quantum,
            interpret=True))
    return out


def _data_mesh(n, auto=False):
    """A pure data-parallel mesh of ``n`` devices.  ``auto``: the axis
    type the reference was written for (JAX 0.4 had only that one); its
    ZeRO step flattens replicated parameters beside data-sharded state,
    which the installed JAX's explicit axes refuse to mix."""
    import jax
    if auto:
        return jax.make_mesh((n,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    return jax.make_mesh((n,), ("data",))


def job_allreduce(a, cases, n):
    """``dps_allreduce_mean_tree`` / ``dps_allreduce_mean`` under
    ``shard_map`` on ``n`` forced CPU devices, nearest rounding; inputs are
    stacked on a leading rank axis.  Returns the mean and the psum'ed
    dispatch-leg stats."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist import collectives as coll
    mesh = _data_mesh(n)
    out = {}
    for name, c in cases.items():
        p = f"{name}/"
        fmt = _fmt(a, p)
        if c["kind"] == "tree":
            tree = unflatten(a, p + "tree/")
            tree = jax.tree.map(jnp.asarray, tree)
            specs = jax.tree.map(lambda _: P("data"), tree)

            def body(tr, k, fmt=fmt):
                tr = jax.tree.map(lambda v: v[0], tr)
                m, s = coll.dps_allreduce_mean_tree(tr, fmt, "data", k,
                                                    mode="nearest")
                return m, coll.psum_stats(s, "data")
            f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs, P()),
                                      out_specs=(P(), P()), check_vma=False))
            m, s = f(tree, jax.random.key(0))
            out.update(flatten(jax.tree.map(np.asarray, m), p + "mean/"))
        else:
            gs = tuple(c["group_sizes"]) if c.get("group_sizes") else None

            def body(xs, k, fmt=fmt, gs=gs):
                m, s = coll.dps_allreduce_mean(xs[0], fmt, "data", k,
                                               mode="nearest", group_sizes=gs)
                return m, coll.psum_stats(s, "data")
            f = jax.jit(jax.shard_map(body, mesh=mesh,
                                      in_specs=(P("data"), P()),
                                      out_specs=(P(), P()), check_vma=False))
            m, s = f(jnp.asarray(a[p + "x"]), jax.random.key(0))
            out[p + "mean"] = np.asarray(m)
        out.update({p + k: v for k, v in _stats_out(s).items()})
    return out


def job_wire_lm_train(a, steps, seq, batch, n, qkw=None):
    """Smoke llama3.2-3b from ``init_params(key(0))``: ``steps`` SGD steps
    under nearest rounding with the int8 gradient all-reduce over ``n``
    forced CPU devices, per-layer wire formats (``qkw`` adds QuantConfig
    fields, e.g. ZeRO-1 and the overlap)."""
    import dataclasses
    import jax
    from repro.core import qtrain
    from repro.data import TokenStream, TokenStreamConfig
    from repro.models import registry
    from repro.models.common import init_params
    from repro.optim import SGDConfig, make_optimizer
    cfg = dataclasses.replace(_smoke_cfg(), remat="full")
    mod = registry(cfg.family)
    params = init_params(jax.random.key(0), mod.model_defs(cfg))
    out = flatten(_np_params(params), "params/")
    qcfg = qtrain.QuantConfig(rounding="nearest", grad_allreduce_bits=8,
                              **(qkw or {}))
    qcfg = qcfg.with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig())
    mesh = _data_mesh(n, auto=(qkw or {}).get("zero_opt_shards") is not None)
    step = qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg, mesh=mesh)
    assert step.wire_sync_active
    opt_state = (qtrain.zero_opt_state(opt, params, n, qcfg=qcfg)
                 if qtrain.zero_opt_engaged(qcfg, mesh) else opt.init(params))
    state = qtrain.TrainState.create(params, opt_state, qcfg,
                                     jax.random.key(1))
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch, seed=0))
    names = ("loss", "il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g",
             "il_wire_grads", "fl_wire_grads", "il_wire_grads_min",
             "il_wire_grads_max", "fl_wire_grads_min", "fl_wire_grads_max",
             "E_wire", "R_wire", "E_g", "E_a")
    state, hist = _run_train(jax.jit(step), state,
                             [data.batch(i) for i in range(steps)], names)
    out.update({f"hist/{k}": v for k, v in hist.items()})
    out.update(flatten(_np_params(state.params), "final/"))
    return out


def job_zero_geometry(a, cases):
    """``ZeroPartitioner`` / ``GroupAlignedPartitioner`` geometry for trees
    of the given leaf shapes (``cases[name] = {"shapes": [...], "n": n,
    "quantum": q, "buckets": runs or None}``; ``quantum`` None builds the
    plain partitioner)."""
    import jax
    from repro.dist.sharding import GroupAlignedPartitioner, ZeroPartitioner
    out = {}
    for name, c in cases.items():
        tree = {f"l{i:02d}": jax.ShapeDtypeStruct(tuple(s), np.float32)
                for i, s in enumerate(c["shapes"])}
        p = f"{name}/"
        if c.get("quantum") is None:
            part = ZeroPartitioner.create(tree, c["n"])
            out[p + "sizes"] = np.asarray([part.size, part.shard_size,
                                           part.padded_size], np.int64)
            continue
        bk = c.get("buckets")
        part = GroupAlignedPartitioner.create(
            tree, c["n"], quantum=c["quantum"],
            buckets=None if bk is None else [tuple(r) for r in bk])
        out[p + "sizes"] = np.asarray([part.size, part.shard_size,
                                       part.padded_size, part.n_buckets],
                                      np.int64)
        B, G = part.n_buckets, len(c["shapes"])
        out[p + "bucket_offset"] = np.asarray(
            [part.bucket_offset(b) for b in range(B)], np.int64)
        out[p + "shard_offset"] = np.asarray(
            [part.shard_offset(b) for b in range(B)], np.int64)
        out[p + "leaf_range"] = np.asarray(
            [part.leaf_range(b) for b in range(B)], np.int64)
        out[p + "leaf_offset"] = np.asarray(
            [part.leaf_offset(g) for g in range(G)], np.int64)
    return out


def job_plan_buckets(a, cases):
    """``overlap.plan_buckets`` runs, each padded to a ``[B, G]`` matrix
    of leaf indices (-1 past a run's end)."""
    from repro.dist.overlap import plan_buckets
    out = {}
    for name, c in cases.items():
        plan = plan_buckets(tuple(c["sizes"]), c["target"])
        m = np.full((plan.n_buckets, len(c["sizes"])), -1, np.int64)
        for b, run in enumerate(plan.buckets):
            m[b, :len(run)] = run
        out[f"{name}/runs"] = m
    return out


def _rank_tree(a, prefix, n):
    """The ranks' trees, stacked on a leading rank axis, from keys
    ``prefix<leaf>``."""
    import jax
    import jax.numpy as jnp
    tree = unflatten(a, prefix)
    return jax.tree.map(jnp.asarray, tree)


def job_zero_halves(a, cases, n):
    """The reference's ZeRO halves and bucketed all-reduce under
    ``shard_map`` on ``n`` forced CPU devices, nearest rounding.  Each
    case names a ``kind``: ``rs`` (``dps_reduce_scatter_mean`` of a flat
    vector), ``ag`` (``dps_allgather_params`` of shards), ``zrs``
    (``zero_bucketed_reduce_scatter`` of a tree over a partitioner),
    ``zag`` (``zero_allgather_params`` of a partitioner's shards),
    ``bucketed`` (``bucketed_allreduce_mean_tree``).  Returns every rank's
    result (stacked) and the psum'ed stats."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist import collectives as coll
    from repro.dist import overlap as ov
    from repro.dist.sharding import GroupAlignedPartitioner
    mesh = _data_mesh(n)
    out = {}
    for name, c in cases.items():
        p = f"{name}/"
        fmt = _fmt(a, p)
        kind = c["kind"]
        part = None
        if kind in ("zrs", "zag"):
            like = unflatten(a, p + "like/")
            like = jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape[1:],
                                                               np.float32),
                                like)
            bk = c.get("buckets")
            part = GroupAlignedPartitioner.create(
                like, n, quantum=c["quantum"],
                buckets=None if bk is None else [tuple(r) for r in bk])

        if kind in ("rs", "ag", "zag"):
            x = jnp.asarray(a[p + "x"])

            def body(xs, k, fmt=fmt, kind=kind, part=part):
                if kind == "rs":
                    r, s = coll.dps_reduce_scatter_mean(xs[0], fmt, "data", k,
                                                        mode="nearest")
                elif kind == "ag":
                    r, s = coll.dps_allgather_params(xs[0], fmt, "data", k,
                                                     mode="nearest")
                else:
                    r, s = ov.zero_allgather_params(xs[0], fmt, "data", k,
                                                    part=part, mode="nearest")
                return r[None], coll.psum_stats(s, "data")
            f = jax.jit(jax.shard_map(body, mesh=mesh,
                                      in_specs=(P("data"), P()),
                                      out_specs=(P("data"), P()),
                                      check_vma=False))
            r, s = f(x, jax.random.key(0))
        else:
            tree = _rank_tree(a, p + "tree/", n)
            specs = jax.tree.map(lambda _: P("data"), tree)

            def body(tr, k, fmt=fmt, kind=kind, part=part, c=c):
                tr = jax.tree.map(lambda v: v[0], tr)
                if kind == "zrs":
                    r, s = ov.zero_bucketed_reduce_scatter(
                        tr, fmt, "data", k, part=part, mode="nearest")
                    r = r[None]
                else:
                    r, s = ov.bucketed_allreduce_mean_tree(
                        tr, fmt, "data", k, mode="nearest",
                        target_elems=c["target"])
                    r = jax.tree.map(lambda v: v[None], r)
                return r, coll.psum_stats(s, "data")
            f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs, P()),
                                      out_specs=(P("data"), P()),
                                      check_vma=False))
            r, s = f(tree, jax.random.key(0))
        if isinstance(r, dict):
            out.update(flatten(jax.tree.map(np.asarray, r), p + "out/"))
        else:
            out[p + "out"] = np.asarray(r)
        out.update({p + k: v for k, v in _stats_out(s).items()})
    return out


def job_zero_mlp_train(a, steps, n, wire_overlap=False, bucket_elems=None,
                       master_weights=False):
    """A fully quantized two-layer MLP (no leaf the policy excludes, so the
    params all-gather rides the int8 wire): ``steps`` ZeRO-1 SGD steps
    under nearest rounding, per-layer wire formats, on ``n`` forced CPU
    devices; the parameters and the batch come from the inputs.  With
    ``master_weights`` the params leg stays fp32: the warnings the step
    gives come back too."""
    import warnings
    import jax
    import jax.numpy as jnp
    from repro.core import qtrain
    from repro.optim import SGDConfig, make_optimizer

    def loss_fn(params, batch, qctx=None):
        h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
        return jnp.mean((h @ params["w2"] - batch["y"]) ** 2), {}

    params = jax.tree.map(jnp.asarray, unflatten(a, "params/"))
    batch = {k: jnp.asarray(a[k]) for k in ("x", "y")}
    qcfg = qtrain.QuantConfig(rounding="nearest", grad_allreduce_bits=8,
                              zero_opt_shards=n, wire_overlap=wire_overlap,
                              wire_bucket_elems=bucket_elems,
                              master_weights=master_weights)
    qcfg = qcfg.with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    mesh = _data_mesh(n, auto=True)
    assert qtrain.wire_params_engaged(qcfg, params, mesh) != master_weights
    step = qtrain.make_train_step(loss_fn, opt, qcfg, mesh=mesh)
    assert step.zero_opt_active and step.zero_groupaligned_active
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, n, qcfg=qcfg), qcfg,
        jax.random.key(1))
    names = ("loss", "il_w", "fl_w", "il_g", "fl_g", "il_wire_grads",
             "fl_wire_grads", "il_wire_params", "fl_wire_params", "E_wire",
             "R_wire")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, hist = _run_train(jax.jit(step), state, [batch] * steps,
                                 names)
    out = {f"hist/{k}": v for k, v in hist.items()}
    out["warnings"] = np.array(json.dumps([str(w.message) for w in caught]))
    out.update(flatten(_np_params(state.params), "final/"))
    # the flat state as the reference keeps it (rank-major shards), and
    # as the parameter tree it belongs to
    part = qtrain.zero_partitioner(qcfg, params, n)
    mu = state.opt_state["mu"]
    out["opt/mu"] = np.asarray(mu)
    out.update(flatten(_np_params(part.unflatten(part.assemble(
        mu.reshape(n, part.shard_size)))), "opt_tree/"))
    return out


# one ⟨IL, FL⟩ = ⟨1, 7⟩ for the params leg, whatever the controller sees:
# too narrow for weights of magnitude 1 and more (test_torch_resilience_zero)
NARROW_WIRE_PARAMS = dict(il_min=1, il_max=1, fl_min=7, fl_max=7, il_init=1,
                          fl_init=7, total_bits=8, max_total=8)
GUARDED_ZERO_METRICS = ("loss", "il_w", "fl_w", "il_g", "fl_g",
                        "il_wire_grads", "fl_wire_grads", "il_wire_params",
                        "fl_wire_params", "E_wire", "R_wire", "health",
                        "skipped", "trips", "degraded")


def _mlp_zero_loss(params, batch, qctx=None):
    import jax.numpy as jnp
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] - batch["y"]) ** 2), {}


def _guarded_zero_setup(a, n, model, layout, guards=True, faults=None,
                        bucket_elems=None, narrow_params=False, cooldown=1):
    """The reference's ZeRO-1 set-up of a guarded case (see
    :func:`job_guarded_zero_train`): (step, state, batches, qcfg)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.core import qtrain
    from repro.core.dps import DPSHyper
    from repro.optim import SGDConfig, make_optimizer
    from repro.resilience import FaultPlan, GuardConfig
    if model == "mlp":
        loss_fn = _mlp_zero_loss
        params = jax.tree.map(jnp.asarray, unflatten(a, "params/"))
        batch = {k: jnp.asarray(a[k]) for k in ("x", "y")}
        batch_at = lambda i: batch
        opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    else:
        from repro.data import TokenStream, TokenStreamConfig
        from repro.models import registry
        from repro.models.common import init_params
        cfg = dataclasses.replace(_smoke_cfg(), remat="full")
        mod = registry(cfg.family)
        loss_fn = mod.loss_fn(cfg)
        params = init_params(jax.random.key(0), mod.model_defs(cfg))
        data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=8,
                                             global_batch=2 * n, seed=0))
        batch_at = data.batch
        opt = make_optimizer(SGDConfig())
    kw = dict(rounding="nearest", grad_allreduce_bits=8, zero_opt_shards=n)
    if guards:
        kw["guards"] = GuardConfig(cooldown=cooldown)
    if layout == "overlap":
        kw.update(wire_overlap=True, wire_bucket_elems=bucket_elems)
    if narrow_params:
        kw["hyper_wire_params"] = DPSHyper(**NARROW_WIRE_PARAMS)
    qcfg = qtrain.QuantConfig(**kw)
    if layout != "plain":
        qcfg = qcfg.with_per_layer_wire(params)
    mesh = _data_mesh(n, auto=True)
    step = qtrain.make_train_step(
        loss_fn, opt, qcfg, mesh=mesh,
        faults=FaultPlan(**faults) if faults else None)
    assert step.zero_opt_active
    assert step.zero_groupaligned_active == (layout != "plain")
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, n, qcfg=qcfg), qcfg,
        jax.random.key(1))
    return jax.jit(step), state, batch_at, qcfg, params


def job_guarded_zero_train(a, steps, n, model, layout, faults=None,
                           bucket_elems=None, narrow_params=False,
                           guards=True):
    """ZeRO-1 with the health guards (``GuardConfig(cooldown=1)``) on ``n``
    forced CPU devices, nearest rounding, ``steps`` SGD steps: ``model``
    "mlp" (:func:`job_zero_mlp_train`'s, every leaf quantized, parameters
    and batch from the inputs) or "lm" (the smoke LM from
    ``init_params(key(0))`` on the token stream, batch ``2n`` x 8);
    ``layout`` "plain" (one global wire format), "aligned" (per-layer
    formats) or "overlap" (per-layer, the overlapped wire of
    ``bucket_elems``); ``faults``: ``FaultPlan`` fields; ``narrow_params``:
    the params leg pinned to ⟨1, 7⟩.  Returns each step's metrics and
    ``degraded`` vector, the initial and final parameters, the final flat
    optimizer state and guard state."""
    from repro.core import qtrain
    step, state, batch_at, qcfg, params = _guarded_zero_setup(
        a, n, model, layout, guards=guards, faults=faults,
        bucket_elems=bucket_elems, narrow_params=narrow_params)
    out = flatten(_np_params(params), "params/")
    names = [k for k in GUARDED_ZERO_METRICS
             if guards or k not in ("health", "skipped", "trips", "degraded")]
    hist = {k: [] for k in names}
    deg = []
    for i in range(steps):
        state, m = step(state, batch_at(i))
        for k in names:
            hist[k].append(float(m[k]))
        if guards:
            deg.append(np.asarray(state.guard.degraded))
    out.update({f"hist/{k}": np.asarray(v, np.float64)
                for k, v in hist.items()})
    if guards:
        out["degraded_vec"] = np.stack(deg)
        for f in ("health", "trips", "skipped", "degraded", "cooldown",
                  "overflow_ewma", "gnorm_ewma"):
            out[f"guard/{f}"] = np.asarray(getattr(state.guard, f))
    out.update(flatten(_np_params(state.params), "final/"))
    out["opt/mu"] = np.asarray(state.opt_state["mu"])
    part = qtrain.zero_partitioner(qcfg, params, n)
    out["padded_size"] = np.asarray(part.padded_size)
    return out


def job_zero_restore_step(a, root, at, n):
    """The fully quantized MLP's ZeRO-1 set-up (per-layer formats, no
    guards): restore the checkpoint ``root``/step ``at`` into the fresh
    state through the reference's ``ckpt.restore``, take one step; returns
    its metrics, the parameters and the flat optimizer state after it."""
    from repro.checkpoint import restore
    step, state, batch_at, _, _ = _guarded_zero_setup(
        a, n, "mlp", "aligned", guards=False)
    state, _ = restore(root, at, state)
    state, m = step(state, batch_at(0))
    out = {f"next/{k}": np.asarray(float(m[k]), np.float64)
           for k in GUARDED_ZERO_METRICS[:11]}
    out.update(flatten(_np_params(state.params), "final/"))
    out["opt/mu"] = np.asarray(state.opt_state["mu"])
    return out


def _ckpt_setup(case):
    """The reference's smoke llama3.2-3b training set-up of a checkpoint
    case: ``opt`` ("sgd"/"adamw"), ``n`` data ranks over the int8 wire with
    per-layer formats (0: the replicated step), ``zero`` (ZeRO-1 over the
    ranks), ``guards``, ``rounding``.  Returns (cfg, step, state, opt, qcfg,
    mesh, data)."""
    import dataclasses
    import jax
    from repro.core import qtrain
    from repro.data import TokenStream, TokenStreamConfig
    from repro.launch import specs
    from repro.models import registry
    from repro.models.common import init_params
    from repro.optim import AdamWConfig, SGDConfig, make_optimizer
    from repro.resilience import GuardConfig
    cfg = dataclasses.replace(_smoke_cfg(), remat="full")
    mod = registry(cfg.family)
    n, zero = case.get("n", 0), case.get("zero", False)
    kw = dict(rounding=case.get("rounding", "nearest"))
    if n:
        kw["grad_allreduce_bits"] = 8
    if zero:
        kw["zero_opt_shards"] = n
    if case.get("guards"):
        kw["guards"] = GuardConfig()
    qcfg = specs.per_layer_wire_qcfg(cfg, qtrain.QuantConfig(**kw))
    opt = make_optimizer(AdamWConfig() if case.get("opt") == "adamw"
                         else SGDConfig())
    mesh = _data_mesh(n, auto=zero) if n else None
    params = init_params(jax.random.key(0), mod.model_defs(cfg))
    opt_state = (qtrain.zero_opt_state(opt, params, n, qcfg=qcfg) if zero
                 else opt.init(params))
    state = qtrain.TrainState.create(params, opt_state, qcfg,
                                     jax.random.key(1))
    step = jax.jit(qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg,
                                          mesh=mesh))
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=8,
                                         global_batch=max(2, 2 * n), seed=0))
    return cfg, step, state, opt, qcfg, mesh, data


def _ckpt_flat(state, prefix):
    from repro.checkpoint import flatten_tree
    return {f"{prefix}{k}": v for k, v in flatten_tree(state).items()}


def job_ckpt_keys(a, cases):
    """The key, shape and dtype of every array ``flatten_tree`` gives the
    reference's fresh train state of each case (see :func:`_ckpt_setup`)."""
    out = {}
    for name, case in cases.items():
        state = _ckpt_setup(case)[2]
        out[name + "/keys"] = np.array(json.dumps({
            k: [list(v.shape), str(v.dtype)]
            for k, v in _ckpt_flat(state, "").items()}))
    return out


def job_ckpt_save(a, root, cases):
    """Each case trains ``case["steps"]`` steps, saves a checkpoint at that
    step under ``root/<name>`` (the reference's ``ckpt.save``), then runs one
    more step: its metrics, and the whole state after it, come back."""
    from repro.checkpoint import save
    out = {}
    for name, case in cases.items():
        _, step, state, _, _, _, data = _ckpt_setup(case)
        for i in range(case["steps"]):
            state, _ = step(state, data.batch(i))
        save(os.path.join(root, name), case["steps"], state,
             meta=data.state(case["steps"]))
        state, m = step(state, data.batch(case["steps"]))
        out.update({f"{name}/next/{k}": np.asarray(v, np.float64)
                    for k, v in m.items()})
        out.update(_ckpt_flat(state, f"{name}/after/"))
    return out


def job_ckpt_restore(a, root, cases):
    """Each case restores the checkpoint at ``root/<name>``, step
    ``case["steps"]``, through the reference's ``ckpt.restore`` into its
    ``abstract_train_state`` (with the schema-upgrade defaults), and returns
    the restored state flattened — or, where the restore refuses, the
    error."""
    from repro.checkpoint import restore
    from repro.core import qtrain
    from repro.launch import specs
    out = {}
    for name, case in cases.items():
        cfg, _, _, opt, qcfg, mesh, _ = _ckpt_setup(case)
        template = specs.abstract_train_state(cfg, opt, qcfg, mesh=mesh)
        defaults = qtrain.dps_restore_defaults(qcfg)
        defaults.update(qtrain.guard_restore_defaults(qcfg))
        try:
            state, meta = restore(os.path.join(root, name), case["steps"],
                                  template, defaults=defaults)
        except ValueError as e:
            out[name + "/error"] = np.array(str(e))
            continue
        out.update(_ckpt_flat(state, f"{name}/"))
        out[name + "/cursor"] = np.asarray(meta["cursor"])
    return out


def job_update_guard(a, cases):
    """``resilience.update_guard`` on the inputs of each case: a plan with
    a ``G``-group wire_grads domain, the guard state, the step's signals and
    the new wire_grads controller state; returns the new guard, ``ok`` and
    ``trip_any``."""
    import jax.numpy as jnp
    from repro.core import qtrain
    from repro.core.dps import DpsBundle, FlexState
    from repro.resilience import GuardConfig, GuardState, update_guard
    out = {}
    for name, case in cases.items():
        mine = {k[len(name) + 1:]: jnp.asarray(v) for k, v in a.items()
                if k.startswith(name + "/")}
        qcfg = qtrain.QuantConfig(grad_allreduce_bits=8,
                                  wire_grads_groups=case["groups"])
        plan = qcfg.plan()
        dps = qtrain.init_dps_bundle(qcfg)
        dps = DpsBundle({n: (FlexState(mine["dps/il"], mine["dps/fl"],
                                       mine["dps/max_ema"])
                             if n == "wire_grads" else dps[n])
                         for n in dps.names()})
        guard = GuardState(**{f: mine["guard/" + f] for f in (
            "health", "trips", "skipped", "degraded", "cooldown",
            "overflow_ewma", "gnorm_ewma", "fl_rail", "il_ratchet",
            "prev_il")})
        new, ok, trip_any = update_guard(
            GuardConfig(**case.get("gcfg", {})), plan, guard,
            loss=mine["loss"], grads_bad=mine["grads_bad"],
            gnorm=mine["gnorm"], wire_ov=mine["wire_ov"], new_dps=dps)
        for f in ("health", "trips", "skipped", "degraded", "cooldown",
                  "overflow_ewma", "gnorm_ewma", "fl_rail", "il_ratchet",
                  "prev_il"):
            out[f"{name}/{f}"] = np.asarray(getattr(new, f))
        out[name + "/ok"] = np.asarray(ok)
        out[name + "/trip_any"] = np.asarray(trip_any)
    return out


def job_f32_mean(a, cases):
    """The guards' fp32 fallback of the reference's wire step: a per-leaf
    ``lax.pmean`` under ``shard_map`` over ``n`` forced CPU devices of the
    ranks' trees (``<case>/r<k>/<leaf>``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    out = {}
    for name, case in cases.items():
        n = case["n"]
        trees = [unflatten(a, f"{name}/r{r}/") for r in range(n)]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
        mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])

        def body(t):
            return jax.tree.map(lambda x: jax.lax.pmean(x[0], "data"), t)
        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),),
                                  out_specs=P(), check_vma=False))
        out.update(flatten(jax.tree.map(np.asarray, f(stacked)),
                           f"{name}/mean/"))
    return out


class _Spec:
    """A resolved spec standing in for the reference's ``NamedSharding``
    (a duck-typed mesh makes none): its entries, JSON-able."""

    def __init__(self, spec):
        self.spec = [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_flat(tree, prefix=""):
    if isinstance(tree, _Spec):
        return {prefix[:-1]: tree.spec}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_spec_flat(v, f"{prefix}{k}/"))
    return out


def _fake_mesh(shape, axes):
    """The duck-typed mesh of the reference's rules test
    (``tests/test_substrates.py``): only ``axis_names`` and
    ``devices.shape``."""
    import math
    return type("FakeMesh", (), {
        "axis_names": tuple(axes),
        "devices": type("devices", (), {"shape": tuple(shape),
                                        "size": math.prod(shape)})})


def job_rules(a, cases, mesh):
    """``LogicalRules.resolve_dim`` on the duck-typed ``mesh`` for each
    case ``(logical, dim, taken)``: the axis it binds and the taken set
    after."""
    from repro.dist.sharding import LogicalRules
    m = _fake_mesh(*mesh)
    res = []
    for logical, dim, taken in cases:
        t = set(taken)
        axis = LogicalRules().resolve_dim(logical, dim, m, t)
        res.append([list(axis) if isinstance(axis, tuple) else axis,
                    sorted(t)])
    return {"res": np.array(json.dumps(res))}


def job_specs(a, archs, meshes):
    """The reference's specs (``repro.launch.specs``) on duck-typed meshes
    ``{name: (shape, axes)}``: for every arch, the train state under SGD
    and AdamW with and without ``zero_opt_shards`` (the data axis's size)
    — params and optimizer state — and, at each of its shapes, the
    batch, decode or prefill inputs of that shape's kind.  The module's
    ``NamedSharding`` is replaced by :class:`_Spec`, so the reference's own
    functions run on a mesh that holds no devices.  One JSON object keyed
    ``"<mesh>/<arch>/<part>/<leaf path>"``."""
    from repro.configs.base import SHAPES, applicable_shapes, get_config
    from repro.core import qtrain
    from repro.dist import sharding as sh
    from repro.launch import specs as S
    from repro.optim import AdamWConfig, SGDConfig, make_optimizer
    S.NamedSharding = sh.NamedSharding = lambda mesh, spec: _Spec(spec)
    out = {}
    for mname, (shape, axes) in meshes.items():
        mesh, rules = _fake_mesh(shape, axes), sh.LogicalRules()
        n_data = dict(zip(axes, shape)).get("data", 1)
        for arch in archs:
            cfg = get_config(arch)
            parts = {}
            for oname, opt in (("sgd", make_optimizer(SGDConfig())),
                               ("adamw", make_optimizer(AdamWConfig()))):
                for zname, zero in (("repl", None), ("zero", n_data)):
                    q = qtrain.QuantConfig(zero_opt_shards=zero)
                    st = S.train_state_shardings(cfg, mesh, rules, opt, q)
                    parts[f"{oname}_{zname}/params"] = st.params
                    parts[f"{oname}_{zname}/opt_state"] = st.opt_state
            for sname in applicable_shapes(cfg):
                shp = SHAPES[sname]
                fn = {"train": S.train_batch_shardings,
                      "decode": S.decode_shardings,
                      "prefill": S.prefill_shardings}[shp.kind]
                parts[sname] = fn(cfg, shp, mesh, rules)
            for k, tree in parts.items():
                out.update(_spec_flat(tree, f"{mname}/{arch}/{k}/"))
    return {"specs": np.array(json.dumps(out))}


def _ep_mesh(shape):
    """A (data, model) mesh of forced host devices with Auto axes: under
    the installed JAX's default Explicit axes the reference's
    ``logical_constraint`` raises ("can only refer to Auto axes")."""
    import jax
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def job_moe_a2a(a, seed, arch, overrides, mesh):
    """The reference's MoE layer at smoke size on ``x`` (B, S, D) under
    ``axis_rules`` of a ``mesh`` (data, model) — the all-to-all dispatch
    when the gate takes it — jitted: its output, aux loss and the
    gradients of ``sum(out * w) + aux`` with respect to x and every
    parameter, and the parameters from ``init_params(key(seed))``.
    ``mesh`` None: no binding (the einsum dispatch)."""
    import contextlib
    import jax
    import jax.numpy as jnp
    from repro.dist.sharding import LogicalRules, axis_rules
    from repro.models import moe
    from repro.models.common import init_params
    cfg = _smoke_cfg(arch, overrides)
    p = init_params(jax.random.key(seed), moe.moe_defs(cfg, jnp.float32))
    x, w = jnp.asarray(a["x"]), jnp.asarray(a["w"])

    def loss(p, x):
        y, aux = moe.moe_apply(cfg, p, x)
        return jnp.sum(y * w) + aux, (y, aux)

    m = _ep_mesh(mesh) if mesh else None
    ctx = axis_rules(m, LogicalRules()) if m else contextlib.nullcontext()
    with ctx:
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
    out = flatten(_np_params(p), "params/")
    out.update(flatten(_np_params(gp), "grads/"))
    out.update(y=np.asarray(y), aux=np.asarray(aux), gx=np.asarray(gx))
    return out


def job_a2a_pack(a):
    """The reference's ``_a2a_pack`` and ``_a2a_unpack`` on ``x`` (fp32)
    and on ``x`` cast to bf16."""
    import jax.numpy as jnp
    from repro.models import moe
    x = jnp.asarray(a["x"])
    out = {}
    for name, v in (("f32", x), ("bf16", x.astype(jnp.bfloat16))):
        q = moe._a2a_pack(v)
        out[name + "/q"] = np.asarray(q)
        out[name + "/back"] = np.asarray(moe._a2a_unpack(q, jnp.float32))
    return out


def job_ep_train(a, steps, seq, batch, arch, mesh, overrides=None):
    """Smoke ``arch`` from ``init_params(key(0))``: ``steps`` SGD steps
    under nearest rounding, the step jitted under ``axis_rules`` of a
    ``mesh`` (data, model) as the reference's sharded-step test runs it
    (replicated inputs; the MoE layers on the all-to-all dispatch).
    ``mesh`` None: no binding (the einsum dispatch).  Returns the history
    and the final parameters."""
    import contextlib
    import dataclasses
    import jax
    from repro.core import qtrain
    from repro.data import TokenStream, TokenStreamConfig
    from repro.dist.sharding import LogicalRules, axis_rules
    from repro.launch import specs as specs_lib
    from repro.models import registry
    from repro.models.common import init_params
    from repro.optim import SGDConfig, make_optimizer
    cfg = dataclasses.replace(_smoke_cfg(arch, overrides), remat="full")
    params = init_params(jax.random.key(0),
                         registry(cfg.family).model_defs(cfg))
    out = flatten(_np_params(params), "params/")
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step = specs_lib.build_train_step(cfg, qcfg, opt, accum_steps=1)
    state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                     jax.random.key(1))
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch, seed=0))
    ctx = (axis_rules(_ep_mesh(mesh), LogicalRules()) if mesh
           else contextlib.nullcontext())
    with ctx:
        state, hist = _run_train(jax.jit(step), state,
                                 [data.batch(i) for i in range(steps)],
                                 ("loss", "il_w", "fl_w", "il_a", "fl_a",
                                  "il_g", "fl_g"))
    out.update({f"hist/{k}": v for k, v in hist.items()})
    out.update(flatten(_np_params(state.params), "final/"))
    return out


def job_sharded_step(a, steps, seq, batch, mesh, arch="llama3_2_3b",
                     overrides=None, guards=False, faults=None,
                     grad_allreduce_bits=None, zero_opt_shards=None,
                     whole=True, master_weights=False):
    """The reference's sharded-step check at smoke size
    (``tests/test_dist.py::test_sharded_train_step_matches_single_device``),
    over ``steps`` SGD steps under nearest rounding: the step jitted with
    ``in_shardings``/``out_shardings`` of ``train_state_shardings`` on a
    (data, model) ``mesh`` of forced host devices, under ``axis_rules``,
    and (``whole``) the same step unsharded.  Returns both histories, the
    initial parameters and both runs' final parameters.  A ``vision_embeds``
    array (a VLM's prefix) and a ``frames`` array (an encoder-decoder's
    frame embeddings) from the test ride on every batch, placed over
    ``batch`` as ``train_batch_shardings`` places them.

    ``guards`` (``GuardConfig()``), ``faults`` (``FaultPlan`` fields),
    ``grad_allreduce_bits`` and ``zero_opt_shards`` go into the step, which
    is then built on the mesh (``build_train_step(..., mesh=)``, as the
    reference's CLI builds it, so a wire or ZeRO-1 the mesh cannot honor
    warns and falls back), and so does ``master_weights``: the histories
    add ``health``, ``skipped``,
    ``trips`` and ``degraded`` when guarded, and the sharded run returns
    its warnings, its ``wire_sync_active``/``zero_opt_active`` and the
    ``.dps`` keys, shapes and dtypes of its checkpoint."""
    import dataclasses
    import warnings
    import jax
    from repro.core import qtrain
    from repro.data import TokenStream, TokenStreamConfig
    from repro.dist.sharding import LogicalRules, axis_rules
    from repro.launch import specs as specs_lib
    from repro.models import registry
    from repro.models.common import init_params
    from repro.optim import SGDConfig, make_optimizer
    from repro.resilience import FaultPlan, GuardConfig
    cfg = dataclasses.replace(_smoke_cfg(arch, overrides), remat="full")
    mod = registry(cfg.family)
    params = init_params(jax.random.key(0), mod.model_defs(cfg))
    out = flatten(_np_params(params), "params/")
    qcfg = qtrain.QuantConfig(rounding="nearest",
                              guards=GuardConfig() if guards else None,
                              grad_allreduce_bits=grad_allreduce_bits,
                              zero_opt_shards=zero_opt_shards,
                              master_weights=master_weights)
    opt = make_optimizer(SGDConfig())
    plan = FaultPlan(**faults) if faults else None
    flags = (guards or faults or grad_allreduce_bits is not None
             or zero_opt_shards is not None)
    names = ("loss", "il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g", "E_a",
             "R_a", "E_g", "E_w") + (("health", "skipped", "trips",
                                      "degraded") if guards else ())
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch, seed=0))
    extras = {k: jax.numpy.asarray(a[k]) for k in ("vision_embeds", "frames")
              if k in a}
    batches = [dict(data.batch(i), **extras) for i in range(steps)]

    def fresh():
        return qtrain.TrainState.create(params, opt.init(params), qcfg,
                                        jax.random.key(1))

    if whole:
        step = specs_lib.build_train_step(cfg, qcfg, opt, accum_steps=1,
                                          faults=plan)
        state, hist = _run_train(jax.jit(step), fresh(), batches, names)
        out.update({f"whole/hist/{k}": v for k, v in hist.items()})
        out.update(flatten(_np_params(state.params), "whole/final/"))
    m = _ep_mesh(mesh)
    rules = LogicalRules()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = specs_lib.build_train_step(cfg, qcfg, opt, accum_steps=1,
                                          mesh=m if flags else None,
                                          faults=plan)
    sh = specs_lib.train_state_shardings(cfg, m, rules, opt, qcfg)
    bs = specs_lib.train_batch_shardings(
        cfg, type("S", (), {"batch": batch, "seq": seq})(), m, rules)
    with m, axis_rules(m, rules):
        state = jax.device_put(fresh(), sh)
        jitted = jax.jit(step, in_shardings=(sh, bs),
                         out_shardings=(sh, None))
        state, hist = _run_train(
            jitted, state, [jax.device_put(b, bs) for b in batches], names)
    out.update({f"sharded/hist/{k}": v for k, v in hist.items()})
    out.update(flatten(_np_params(state.params), "sharded/final/"))
    if flags:
        out["sharded/warnings"] = np.array(json.dumps(
            [str(w.message) for w in caught]))
        out["sharded/active"] = np.array([step.wire_sync_active,
                                          step.zero_opt_active])
        out["sharded/dps_keys"] = np.array(json.dumps({
            k: [list(v.shape), str(v.dtype)]
            for k, v in _ckpt_flat(state, "").items()
            if k.startswith(".dps")}))
    return out


def job_sharded_serve(a, arch, mesh, max_seq, overrides=None, whole=True):
    """Smoke ``arch`` from ``init_params(key(0))`` served over a (data,
    model) ``mesh`` of forced host devices (Auto axes), under
    ``axis_rules``, as ``repro.launch.dryrun`` compiles its prefill and
    decode cells: ``build_prefill_step`` jitted with ``in_shardings`` of
    ``param_shardings`` and ``prefill_shardings``, then for each column of
    ``steps`` (B, n), teacher-forced, ``build_decode_step`` jitted with
    ``in_shardings``/``out_shardings`` of ``decode_shardings`` (its cache
    ``cache_logical``'s) and, for the logits, ``decode_step`` under the
    same shardings.  ``tokens`` (B, S) is the prompt; a ``vision_embeds``
    or ``frames`` array rides on the prefill.  Returns the parameters,
    the prefill's last logits, cache and ``pos``, each step's logits and
    greedy token, and the cache and ``pos`` after the last step, under
    ``sharded/``; with ``whole`` the same run jitted without shardings
    under ``whole/``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig
    from repro.dist.sharding import LogicalRules, axis_rules
    from repro.launch import specs as specs_lib
    from repro.models import registry
    from repro.models.common import init_params
    cfg = _smoke_cfg(arch, overrides)
    mod = registry(cfg.family)
    params = init_params(jax.random.key(0), mod.model_defs(cfg))
    out = flatten(_np_params(params), "params/")
    inputs = dict(tokens=jnp.asarray(a["tokens"]),
                  **{k: jnp.asarray(a[k]) for k in ("vision_embeds", "frames")
                     if k in a})
    steps = a["steps"]
    B = steps.shape[0]

    def serve(tag, prefill, decode_logits, decode_tok, put):
        logits, cache, pos = prefill(put("params", params),
                                     put("inputs", inputs))
        out[f"{tag}/prefill_logits"] = np.asarray(logits)
        out.update(flatten(_cache_np(cache), f"{tag}/prefill_cache/"))
        out[f"{tag}/prefill_pos"] = np.asarray(pos)
        lgs, toks = [], []
        for i in range(steps.shape[1]):
            args = (put("params", params),
                    put("tokens", jnp.asarray(steps[:, i:i + 1])),
                    put("cache", cache), put("pos", pos))
            lgs.append(np.asarray(decode_logits(*args)[0]))
            nxt, cache, pos = decode_tok(*args)
            toks.append(np.asarray(nxt))
        out[f"{tag}/decode_logits"] = np.stack(lgs, 1)
        out[f"{tag}/next_tok"] = np.concatenate(toks, 1)
        out.update(flatten(_cache_np(cache), f"{tag}/decode_cache/"))
        out[f"{tag}/decode_pos"] = np.asarray(pos)

    step = specs_lib.build_decode_step(cfg)
    pre = specs_lib.build_prefill_step(cfg, max_seq=max_seq)
    prefill = lambda p, inputs: pre(p, **inputs)
    logit_fn = lambda p, t, c, s: mod.decode_step(cfg, p, t, c, s)
    if whole:
        serve("whole", jax.jit(prefill), jax.jit(logit_fn), jax.jit(step),
              lambda _, v: v)
    m = _ep_mesh(mesh)
    rules = LogicalRules()
    p_sh = specs_lib.param_shardings(cfg, m, rules)
    prompt = inputs["tokens"].shape[1] + (cfg.n_patches if "vision_embeds"
                                          in inputs else 0)
    in_sh = specs_lib.prefill_shardings(
        cfg, ShapeConfig("prefill", "prefill", prompt, B), m, rules)
    d_sh = specs_lib.decode_shardings(
        cfg, ShapeConfig("decode", "decode", max_seq, B), m, rules)
    sh = {"params": p_sh, "inputs": in_sh, **d_sh}
    d_in = (p_sh, d_sh["tokens"], d_sh["cache"], d_sh["pos"])
    with m, axis_rules(m, rules):
        serve("sharded",
              jax.jit(prefill, in_shardings=(p_sh, in_sh)),
              jax.jit(logit_fn, in_shardings=d_in,
                      out_shardings=(None, d_sh["cache"])),
              jax.jit(step, in_shardings=d_in,
                      out_shardings=(d_sh["tokens"], d_sh["cache"],
                                     d_sh["pos"])),
              lambda k, v: jax.device_put(v, sh[k]))
    return out


def job_elastic_restore(a, root, step, meshes, arch="llama3_2_3b"):
    """A checkpoint the port wrote from a placed state, restored by the
    reference's ``ckpt.restore`` into its ``abstract_train_state`` and
    placed by ``train_state_shardings`` on each (data, model) mesh of
    ``meshes`` (``[]``: none), as its ``test_elastic_restore_across_meshes``
    restores across meshes: the parameters and the momentum each time."""
    import jax
    from repro.checkpoint import restore
    from repro.core import qtrain
    from repro.dist.sharding import LogicalRules
    from repro.launch import specs as specs_lib
    from repro.optim import SGDConfig, make_optimizer
    cfg = _smoke_cfg(arch)
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    template = specs_lib.abstract_train_state(cfg, opt, qcfg)
    state, _ = restore(root, step, template)
    out = flatten(_np_params(state.params), "none/params/")
    out.update(flatten(_np_params(state.opt_state), "none/opt/"))
    for shape in meshes:
        m = _ep_mesh(shape)
        sh = specs_lib.train_state_shardings(cfg, m, LogicalRules(), opt,
                                             qcfg)
        placed = jax.device_put(state, sh)
        tag = "x".join(str(n) for n in shape)
        out.update(flatten(_np_params(placed.params), f"{tag}/params/"))
        out.update(flatten(_np_params(placed.opt_state), f"{tag}/opt/"))
    return out


def _report_json(r):
    return {"checked": sorted(r.checked), "fired": list(r.rules_fired())}


def job_lint(a, cells, seq=16):
    """``repro.analysis.lint.lint_cell`` on each cell ``[config, mode,
    wire_overlap, guards]`` over every forced host device: per cell, each
    report's name, sorted ``checked`` and ``rules_fired()`` (JSON), and the
    ring-model ``collective_wire_bytes`` of each HLO it audited."""
    import json as _json
    from repro.analysis import hlo_audit, lint
    from repro.launch.hlo_stats import collective_wire_bytes
    seen = {}
    audit = hlo_audit.audit_hlo

    def spy(hlo_text, claims, name="hlo"):
        seen[name] = collective_wire_bytes(hlo_text)["by_op_dtype"]
        return audit(hlo_text, claims, name=name)

    hlo_audit.audit_hlo = spy
    out = {}
    try:
        for config, mode, overlap, guards in cells:
            seen.clear()
            reps = lint.lint_cell(config, mode, seq=seq,
                                  wire_overlap=overlap, guards=guards)
            key = f"{config}/{mode}/{int(overlap)}{int(guards)}"
            out[key + "/reports"] = np.array(_json.dumps(
                {r.name: _report_json(r) for r in reps}))
            out[key + "/bytes"] = np.array(_json.dumps(seen))
            if mode.startswith("zero"):
                out[key + "/padded"] = np.asarray(
                    _zero_padded(config, mode, overlap), np.int64)
    finally:
        hlo_audit.audit_hlo = audit
    return out


def _zero_padded(config, mode, overlap, n=8):
    """The element count of the flat ZeRO layout the lint cell's step
    shards (its partitioner's ``padded_size``)."""
    import jax
    from repro.analysis import lint
    from repro.core import qtrain
    qcfg = lint._mode_qcfg(mode, n, "flexpoint", overlap)
    if config == "lenet":
        from repro.models import lenet
        params = lenet.init(jax.random.key(0))
        if "per-layer" in mode:
            qcfg = qcfg.with_per_layer_wire(params)
    else:
        from repro.launch import specs as specs_lib
        from repro.optim import SGDConfig, make_optimizer
        cfg = _smoke_cfg(config)
        if "per-layer" in mode:
            qcfg = specs_lib.per_layer_wire_qcfg(cfg, qcfg)
        params = specs_lib.abstract_train_state(
            cfg, make_optimizer(SGDConfig()), qcfg).params
    return qtrain.zero_partitioner(qcfg, params, n).padded_size


def _hlo(*body):
    return "ENTRY main {\n" + "\n".join(f"  {b}" for b in body) + "\n}\n"


def job_analysis_cases(a):
    """Every rule's broken input and its closest correct one, as the
    reference's oracle suite (``tests/test_analysis.py``) builds them, and
    the same for the rules that suite leaves out (the bucket, guard and KV
    rules): per case, the report's ``rules_fired()`` and ``checked``."""
    import dataclasses
    import json as _json
    import jax
    import jax.numpy as jnp
    from repro.analysis import flow, hlo_audit, kernel_checks
    from repro.core import tagging
    from repro.dist import collectives
    from repro.kernels import ops
    axis = [("data", 8)]
    a2a = lambda v: jax.lax.all_to_all(v, "data", split_axis=0,
                                       concat_axis=0, tiled=True)
    cases = {}

    def fn_case(name, fn, *args, axis_env=None):
        cases[name] = flow.analyze_fn(fn, *args, axis_env=axis_env)

    z = jnp.zeros
    fn_case("PF-WIRE-F32/bad", lambda x: a2a(tagging.tag(
        x, "wire_payload", leg="dispatch")), z((8, 32)), axis_env=axis)
    fn_case("PF-WIRE-F32/bad-untagged", lambda x, y: (a2a(tagging.tag(
        x.astype(jnp.int8), "wire_payload", leg="dispatch")), a2a(y)),
        z((8, 32)), z((8, 32)), axis_env=axis)
    fn_case("PF-WIRE-F32/good", lambda x, s: (a2a(tagging.tag(
        x.astype(jnp.int8), "wire_payload", leg="dispatch")),
        jax.lax.psum(s, "data")), z((8, 32)), z(()), axis_env=axis)
    fn_case("PF-REQUANT/bad", lambda x: tagging.tag(
        tagging.tag(x, "decode_out").reshape(-1)[:16], "encode_in",
        domain="wire_grads"), z((4, 8)))
    fn_case("PF-REQUANT/good", lambda x: tagging.tag(
        tagging.tag(x, "decode_out") * 0.5, "encode_in",
        domain="wire_grads"), z((4, 8)))
    fn_case("PF-STATS-ROUTE/bad", lambda x: tagging.tag(
        tagging.tag(x, "wire_stats") + 1.0, "stats_sink", domain="grads",
        wire=False, stream="E"), z(()))
    fn_case("PF-STATS-ROUTE/good", lambda x: tagging.tag(
        tagging.tag(x, "wire_stats") + 1.0, "stats_sink",
        domain="wire_grads", wire=True, stream="E"), z(()))
    fn_case("PF-SR-SEED/bad", lambda x: x + tagging.tag(
        jnp.zeros(x.shape, jnp.uint32), "sr_bits",
        domain="wire_grads").astype(jnp.float32), z((16,)))
    fn_case("PF-SR-SEED/good", lambda x, k: x + tagging.tag(
        jax.random.bits(k, (16,), jnp.uint32), "sr_bits",
        domain="wire_grads").astype(jnp.float32), z((16,)),
        jax.random.key(0))

    def bucket(encodes, after_decode):
        def f(g):
            r = tagging.tag(g, "wire_bucket", stage="ready", bucket=0,
                            leaf=0, n=1)
            for _ in range(encodes):
                tagging.tag(r.reshape(-1), "encode_in")
            dec = after_decode(tagging.tag(g * 0.5, "decode_out"))
            return tagging.tag(dec, "wire_bucket", stage="mean", bucket=0,
                               n=1)
        return f
    same = lambda d: d
    fn_case("PF-BUCKET-ENCODE/bad", bucket(2, same), z((16,)))
    fn_case("PF-BUCKET-ENCODE/bad-dropped", bucket(0, same), z((16,)))
    fn_case("PF-BUCKET-ENCODE/good", bucket(1, same), z((16,)))
    cases["PF-BUCKET-DECODE/good"] = cases["PF-BUCKET-ENCODE/good"]
    fn_case("PF-BUCKET-DECODE/bad", bucket(1, lambda d: d + 1.0), z((16,)))

    def guard(from_stats):
        def f(x, s):
            w = a2a(tagging.tag(x.astype(jnp.int8), "wire_payload",
                                leg="dispatch"))
            st = tagging.tag(s, "wire_stats") if from_stats else z(())
            return w, tagging.tag(st * 2.0, "guard_sink",
                                  domain="wire_grads")
        return f
    fn_case("PF-GUARD-TAINT/bad", guard(False), z((8, 32)), z(()),
            axis_env=axis)
    fn_case("PF-GUARD-TAINT/good", guard(True), z((8, 32)), z(()),
            axis_env=axis)
    fn_case("PF-KV-WIRE/bad", lambda x: tagging.tag(
        x, "kv_page", domain="kv_cache", stage="write", bits=8),
        z((4, 16)))
    fn_case("PF-KV-WIRE/good", lambda x: tagging.tag(
        x.astype(jnp.int8), "kv_page", domain="kv_cache", stage="write",
        bits=8), z((4, 16)))

    c2 = hlo_audit.AuditClaims(engaged=("wire_grads",), two_leg=True,
                               n_wire_elems=4096)
    a8 = "%a = s8[4096]{0} all-to-all(s8[4096]{0} %p)"
    g8 = "%g = s8[4096]{0} all-gather(s8[512]{0} %q)"
    audit = hlo_audit.audit_hlo
    cases["HA-PAYLOAD-DTYPE/bad"] = audit(_hlo(
        "%a = f32[4096]{0} all-to-all(f32[4096]{0} %p)", g8), c2)
    cases["HA-PAYLOAD-DTYPE/bad-gather"] = audit(_hlo(a8), c2)
    cases["HA-PAYLOAD-DTYPE/good"] = audit(_hlo(a8, g8), c2)
    both = dataclasses.replace(c2, engaged=("wire_grads", "wire_params"))
    cases["HA-DOMAIN-COVERAGE/bad"] = audit(
        _hlo(a8), dataclasses.replace(both, two_leg=False))
    cases["HA-DOMAIN-COVERAGE/good"] = audit(_hlo(a8, g8), both)
    cases["HA-WIRE-RATIO/bad"] = audit(_hlo(
        "%a = s8[65536]{0} all-to-all(s8[65536]{0} %p)",
        "%g = s8[65536]{0} all-gather(s8[8192]{0} %q)"), c2)
    cases["HA-WIRE-RATIO/bad-thin"] = audit(_hlo(
        "%a = s8[512]{0} all-to-all(s8[512]{0} %p)",
        "%g = s8[512]{0} all-gather(s8[64]{0} %q)"), c2)
    cases["HA-WIRE-RATIO/good"] = cases["HA-PAYLOAD-DTYPE/good"]
    cases["HA-F32-RESIDUAL/bad"] = audit(_hlo(
        a8, g8, "%r = f32[4096]{0} all-reduce(f32[4096]{0} %x)"), c2)
    cases["HA-F32-RESIDUAL/good"] = audit(_hlo(
        a8, g8, "%r = f32[8]{0} all-reduce(f32[8]{0} %x)"), c2)
    cg = dataclasses.replace(c2, grouped=True)
    cases["HA-F32-CONCAT/bad"] = audit(_hlo(
        "%c = f32[4096]{0} concatenate(f32[2048]{0} %a, f32[2048]{0} %b)",
        a8, g8), cg)
    cases["HA-F32-CONCAT/good"] = audit(_hlo(a8, g8), cg)
    pool = 4 * 64 * 16
    dec = hlo_audit.audit_decode_hlo
    cases["HA-KV-DTYPE/bad"] = dec(_hlo(
        "%k = s8[4,64]{1,0} parameter(0)"), pool_elems=pool, bits=8)
    cases["HA-KV-DTYPE/good"] = dec(_hlo(
        "%k = s8[4,64,16]{2,1,0} parameter(0)"), pool_elems=pool, bits=8)
    cases["HA-KV-F32-CACHE/bad"] = dec(_hlo(
        "%k = s8[4,64,16]{2,1,0} parameter(0)",
        "%d = f32[4,64,16]{2,1,0} convert(s8[4,64,16]{2,1,0} %k)"),
        pool_elems=pool, bits=8)
    cases["HA-KV-F32-CACHE/good"] = cases["HA-KV-DTYPE/good"]

    geom = ops.group_wire_call_geometry(8 * 4096, 4, 4096)
    check = kernel_checks.check_call
    cases["KG-SMEM-TABLE/bad"] = check(
        dataclasses.replace(geom, table_rows=5), expected_groups=4)
    cases["KG-SMEM-TABLE/bad-budget"] = check(dataclasses.replace(
        geom, table_rows=20000,
        scalar_shapes=((20000, 2),) + geom.scalar_shapes[1:]),
        expected_groups=20000)
    cases["KG-SMEM-TABLE/good"] = check(geom, expected_groups=4)
    cases["KG-PREFETCH-ARITY/bad"] = check(
        dataclasses.replace(geom, num_scalar_prefetch=1), expected_groups=4)
    cases["KG-PREFETCH-ARITY/good"] = cases["KG-SMEM-TABLE/good"]
    cases["KG-TILE-MIN/bad"] = check(
        dataclasses.replace(geom, block=(8, 128)), expected_groups=4)
    cases["KG-TILE-MIN/bad-quantum"] = check(
        dataclasses.replace(geom, quantum=4096 + 128), expected_groups=4)
    cases["KG-TILE-MIN/good"] = cases["KG-SMEM-TABLE/good"]
    lay = collectives.group_layout((5000, 3000), n_chunks=8, quantum=4096)
    lcheck = kernel_checks.check_layout
    cases["KG-TILE-STRADDLE/good"] = lcheck(lay)
    cases["KG-TILE-STRADDLE/bad"] = lcheck(
        dataclasses.replace(lay, offsets=(0, 5000)))
    cases["KG-TILE-STRADDLE/bad-padded"] = lcheck(
        dataclasses.replace(lay, padded=(4096, 4096)))
    cases["KG-TILE-STRADDLE/bad-chunk"] = lcheck(
        dataclasses.replace(lay, chunk=lay.chunk + 1))
    return {"cases": np.array(_json.dumps(
        {k: _report_json(r) for k, r in cases.items()}))}


def job_precision_plan(a, steps, n_train, fl_init):
    """LeNet from ``lenet.init(key(0))``: ``steps`` SGD steps under
    ``paper_quant_config(rounding="nearest", fl_init=...)`` on
    ``MNISTLike(n_train=...)``, in four cases: ``ext`` — the standard plan
    with two wire domains and a static ``kv_cache`` domain added
    (``tests/test_precision_plan.py::test_bits_none_step_bitexact_under_
    extra_domains``); ``gd`` — the optimizer's ``grad_domain`` is
    ``opt_in``, a paper controller from ⟨6, 10⟩ fed the grads stream;
    ``master`` — ``master_weights``; ``missing`` — the ``ValueError`` of
    a ``grad_domain`` the plan lacks.  Histories (with ``opt_in``'s
    formats in ``gd``) and the final parameters of ``master``."""
    import dataclasses
    import jax
    from repro.apps.mnist import paper_quant_config
    from repro.core import qtrain
    from repro.core.dps import DomainSpec, DPSHyper, PrecisionPlan, wire_hyper
    from repro.data import MNISTLike
    from repro.models import lenet
    from repro.optim import SGDConfig, make_optimizer
    params = lenet.init(jax.random.key(0))
    base = paper_quant_config(rounding="nearest", fl_init=fl_init)
    domains = base.plan().domains
    data = MNISTLike(batch=64, seed=0, n_train=n_train, n_test=64)
    batches = [data.train_batch(i) for i in range(steps)]
    names = ("loss", "il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
    cases = {
        "ext": (PrecisionPlan(domains + (
            ("wire_grads", DomainSpec("flexpoint", wire_hyper(8, 6, -2.0))),
            ("wire_params", DomainSpec("flexpoint", wire_hyper(8, 2, 1.0))),
            ("kv_cache", DomainSpec("static", DPSHyper(il_init=8,
                                                       fl_init=8))))),
                "grads", False),
        "gd": (PrecisionPlan(domains + (("opt_in", DomainSpec(
            "paper", DPSHyper(il_init=6, fl_init=10), stats="grads")),)),
               "opt_in", False),
        "master": (None, "grads", True),
        "missing": (None, "nope", False)}
    out = flatten(_np_params(params), "params/")
    for case, (plan, grad_domain, master) in cases.items():
        qcfg = dataclasses.replace(base, precision_plan=plan,
                                   master_weights=master)
        opt = make_optimizer(SGDConfig())
        opt.grad_domain = grad_domain
        try:
            step = qtrain.make_train_step(lenet.loss_fn, opt, qcfg)
        except ValueError as e:
            out[f"{case}/error"] = np.array(str(e))
            continue
        state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                         jax.random.key(1))
        state, hist = _run_train(jax.jit(step), state, batches,
                                 names + (("il_opt_in", "fl_opt_in")
                                          if case == "gd" else ()))
        out.update({f"{case}/hist/{k}": v for k, v in hist.items()})
        out.update(flatten(_np_params(state.params), f"{case}/final/"))
    return out


def _dot_flops(hlo_text):
    """FLOPs of the ``dot(`` instructions of an HLO module: ``2 ×`` the
    result's elements ``×`` the lhs operand's contracted extent (operand
    shapes are looked up by name: the module prints them only where they
    are defined)."""
    import math
    import re
    define = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
    dot = re.compile(r"=\s*\w+\[([\d,]*)\]\S*\s+dot\(%?([\w.\-]+)"
                     r".*?lhs_contracting_dims=\{([\d,]*)\}")
    dims = lambda t: [int(d) for d in t.split(",") if d]
    shapes = {}
    for line in hlo_text.splitlines():
        m = define.match(line)
        if m:
            shapes[m.group(1)] = dims(m.group(2))
    total = 0
    for line in hlo_text.splitlines():
        m = dot.search(line)
        if m:
            lhs = shapes[m.group(2)]
            total += 2 * math.prod(dims(m.group(1))) * math.prod(
                lhs[i] for i in dims(m.group(3)))
    return float(total)


def _entry_params(hlo_text):
    """``[(op_name, bytes)]`` of the ENTRY computation's parameters."""
    import math
    import re
    entry = hlo_text[hlo_text.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    width = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "s8": 1, "u8": 1,
             "f64": 8, "s64": 8, "pred": 1}
    pat = re.compile(r"=\s*(\w+)\[([\d,]*)\].*parameter\(\d+\).*"
                     r'op_name="([^"]*)"')
    out = []
    for line in entry.splitlines():
        m = pat.search(line)
        if m:
            n = math.prod(int(d) for d in m.group(2).split(",") if d)
            out.append((m.group(3), n * width[m.group(1)]))
    return out


def job_dryrun_cell(a, arch, kinds, seq, batch, mesh):
    """The reference dry run's compile functions (``_compile_train``,
    ``_compile_prefill``, ``_compile_decode``) at ``arch``'s smoke size
    with ``probe_unroll=True`` on a (data, model) ``mesh`` of forced host
    devices: per kind, ``memory_analysis().argument_size_in_bytes``, the
    ring-model ``collective_wire_bytes`` and the FLOPs of the compiled
    HLO's ``dot(`` instructions (one device's)."""
    import dataclasses
    import json as _json
    import jax
    jax.devices()       # the backend keeps its device count from here on
    from repro.configs.base import ShapeConfig
    from repro.dist.sharding import LogicalRules
    from repro.launch import dryrun
    from repro.launch.hlo_stats import collective_wire_bytes
    cfg = dataclasses.replace(_smoke_cfg(arch), probe_unroll=True)
    m = _ep_mesh(mesh)
    out = {}
    for kind in kinds:
        shape = ShapeConfig(f"smoke_{kind}", kind, seq, batch)
        _, compiled = dryrun.KIND_COMPILERS[kind](cfg, shape, m,
                                                  LogicalRules())
        hlo = compiled.as_text()
        out[f"{kind}/argument_bytes"] = np.asarray(
            compiled.memory_analysis().argument_size_in_bytes, np.int64)
        out[f"{kind}/dot_flops"] = np.asarray(_dot_flops(hlo), np.float64)
        out[f"{kind}/params"] = np.array(_json.dumps(_entry_params(hlo)))
        out[f"{kind}/wire"] = np.array(_json.dumps(
            collective_wire_bytes(hlo)["by_op_dtype"]))
    return out


def _child_main(fin, fout):
    import jax
    import jax.extend.core
    # the shim: the installed JAX keeps these names under jax.extend.core
    # only, and repro.core.tagging / repro.analysis.flow use them
    for name in ("Primitive", "Jaxpr", "ClosedJaxpr", "Literal", "Var"):
        setattr(jax.core, name, getattr(jax.extend.core, name))
    with np.load(fin) as z:
        arrays = {k: z[k] for k in z.files}
    jobs = json.loads(str(arrays.pop("__jobs__")))
    out = {}
    for spec in jobs:
        tag = spec["tag"] + "/"
        mine = {k[len(tag):]: v for k, v in arrays.items()
                if k.startswith(tag)}
        res = globals()["job_" + spec["job"]](mine, **spec.get("kw", {}))
        out.update({tag + k: v for k, v in res.items()})
    np.savez(fout, **out)


if __name__ == "__main__":
    _child_main(sys.argv[1], sys.argv[2])
