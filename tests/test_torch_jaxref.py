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

Importing this module imports neither ``jax`` nor ``repro``.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_NAMES = ("count", "nonzero", "overflow", "abs_err_sum", "rel_err_sum",
              "abs_sum", "max_abs")


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

def run_reference(jobs, arrays=None, timeout=900):
    """Run ``jobs`` in one child process against the JAX package.

    ``jobs``: list of ``{"job": <name of a job_* function below>, "tag":
    <prefix>, "kw": {json-able keyword arguments}}``.  ``arrays``: dict of
    numpy arrays keyed ``"<tag>/<name>"``; a job sees those under its tag
    with the prefix stripped.  Returns the outputs keyed the same way.
    """
    arrays = dict(arrays or {})
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(fin, __jobs__=np.array(json.dumps(jobs)), **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(REPO, "src"))
        env.pop("XLA_FLAGS", None)
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
