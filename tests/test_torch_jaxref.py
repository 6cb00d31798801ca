"""The JAX package as a live oracle for the PyTorch port's tests.

The reference never runs inside the pytest worker.  :func:`run_reference`
starts ONE child process per call (the port's test modules call it once, from
a module-scoped fixture), hands it an ``.npz`` of inputs and a list of jobs,
and reads back an ``.npz`` of outputs.  The child is this same file run as a
script: it sets ``jax.core.Primitive = jax.extend.core.Primitive`` (the
installed JAX no longer has the former, which ``repro.core.tagging`` uses),
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

def run_reference(jobs, arrays=None, timeout=900, host_devices=None):
    """Run ``jobs`` in one child process against the JAX package.

    ``jobs``: list of ``{"job": <name of a job_* function below>, "tag":
    <prefix>, "kw": {json-able keyword arguments}}``.  ``arrays``: dict of
    numpy arrays keyed ``"<tag>/<name>"``; a job sees those under its tag
    with the prefix stripped.  Returns the outputs keyed the same way.
    ``host_devices``: the child forces that many CPU devices
    (``--xla_force_host_platform_device_count``), for jobs that run the
    reference's collectives under ``shard_map``.
    """
    arrays = dict(arrays or {})
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(fin, __jobs__=np.array(json.dumps(jobs)), **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(REPO, "src"))
        env.pop("XLA_FLAGS", None)
        if host_devices:
            env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                                f"{int(host_devices)}")
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


def _smoke_cfg():
    from repro.configs.base import get_config, smoke
    return smoke(get_config("llama3_2_3b"))


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


def _smoke_params(seed):
    import jax
    from repro.models import registry
    from repro.models.common import init_params
    cfg = _smoke_cfg()
    mod = registry(cfg.family)
    return cfg, mod, init_params(jax.random.key(seed), mod.model_defs(cfg))


def job_model(a, seed, layout):
    """Smoke params plus prefill logits, contiguous decode logits and one
    paged decode step on shared pools."""
    import jax.numpy as jnp
    cfg, mod, params = _smoke_params(seed)
    out = flatten(_np_params(params), "params/")
    toks = jnp.asarray(a["tokens"])
    max_seq = toks.shape[1] + 4
    logits, cache, pos = mod.prefill(cfg, params, toks, max_seq)
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


def job_engine(a, seed, layout, traces):
    """The reference Engine over synthetic traces, kv_bits 8 and None."""
    from repro.serve import Engine, EngineConfig, synthetic_trace
    cfg, mod, params = _smoke_params(seed)
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


def job_lm_train(a, steps, seq, batch, remat):
    """Smoke llama3.2-3b from ``init_params(key(0))``: ``steps`` SGD steps
    under nearest rounding on the synthetic token stream."""
    import dataclasses
    import jax
    from repro.core import qtrain
    from repro.data import TokenStream, TokenStreamConfig
    from repro.models import registry
    from repro.models.common import init_params
    from repro.optim import SGDConfig, make_optimizer
    cfg = dataclasses.replace(_smoke_cfg(), remat=remat)
    mod = registry(cfg.family)
    params = init_params(jax.random.key(0), mod.model_defs(cfg))
    out = flatten(_np_params(params), "params/")
    qcfg = qtrain.QuantConfig(rounding="nearest")
    opt = make_optimizer(SGDConfig())
    step_fn = jax.jit(qtrain.make_train_step(mod.loss_fn(cfg), opt, qcfg))
    state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                     jax.random.key(1))
    data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch, seed=0))
    _, hist = _run_train(step_fn, state,
                         [data.batch(i) for i in range(steps)])
    out.update({f"hist/{k}": v for k, v in hist.items()})
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


def job_zero_mlp_train(a, steps, n, wire_overlap=False, bucket_elems=None):
    """A fully quantized two-layer MLP (no leaf the policy excludes, so the
    params all-gather rides the int8 wire): ``steps`` ZeRO-1 SGD steps
    under nearest rounding, per-layer wire formats, on ``n`` forced CPU
    devices; the parameters and the batch come from the inputs."""
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
                              wire_bucket_elems=bucket_elems)
    qcfg = qcfg.with_per_layer_wire(params)
    opt = make_optimizer(SGDConfig(lr=0.05, schedule="const"))
    mesh = _data_mesh(n, auto=True)
    assert qtrain.wire_params_engaged(qcfg, params, mesh)
    step = qtrain.make_train_step(loss_fn, opt, qcfg, mesh=mesh)
    assert step.zero_opt_active and step.zero_groupaligned_active
    state = qtrain.TrainState.create(
        params, qtrain.zero_opt_state(opt, params, n, qcfg=qcfg), qcfg,
        jax.random.key(1))
    names = ("loss", "il_w", "fl_w", "il_g", "fl_g", "il_wire_grads",
             "fl_wire_grads", "il_wire_params", "fl_wire_params", "E_wire",
             "R_wire")
    state, hist = _run_train(jax.jit(step), state, [batch] * steps, names)
    out = {f"hist/{k}": v for k, v in hist.items()}
    out.update(flatten(_np_params(state.params), "final/"))
    # the flat state as the reference keeps it (rank-major shards), and
    # as the parameter tree it belongs to
    part = qtrain.zero_partitioner(qcfg, params, n)
    mu = state.opt_state["mu"]
    out["opt/mu"] = np.asarray(mu)
    out.update(flatten(_np_params(part.unflatten(part.assemble(
        mu.reshape(n, part.shard_size)))), "opt_tree/"))
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


def _child_main(fin, fout):
    import jax
    import jax.extend.core
    jax.core.Primitive = jax.extend.core.Primitive   # the one-line shim
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
