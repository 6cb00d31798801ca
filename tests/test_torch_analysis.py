"""The port's precision-flow verifier (``repro_torch.analysis``) rule by rule.

Every one of the 19 rule IDs fires on a broken trace, layout or launch
geometry and stays quiet on the closest correct one — and the reference's
verifier, run on its counterpart input in one child process (job
``analysis_cases`` of ``tests/test_torch_jaxref.py``: the broken inputs of
``tests/test_analysis.py`` and the same for the bucket, guard and KV rules),
fires exactly the same rules.  The port's inputs are traces recorded by
:class:`~repro_torch.analysis.trace.Trace` over tensors, landmarks and a
stacked transport of 8 ranks (one rank's bytes per collective, as the
reference's SPMD HLO counts them); the geometry cases break real launch
geometries and layouts field by field.

Then the recorder itself: it follows in-place writes (into a view, and the
tensor the view belongs to), views, and the backward's hooks.
"""

import dataclasses
import json

import pytest
import torch

from repro_torch.analysis import flow, kernel_checks, trace_audit
from repro_torch.analysis.trace import Trace
from repro_torch.core import tagging
from repro_torch.dist import collectives
from repro_torch.dist.transport import StackedTransport
from repro_torch.kernels import _build
from repro_torch.kernels import dps_quant as dq
from repro_torch.kernels import ops
from repro_torch.kernels.dps_quant import Philox
from repro_torch.launch import trace_stats

from test_torch_jaxref import run_reference

N = 8
RULES = ("PF-WIRE-F32", "PF-REQUANT", "PF-STATS-ROUTE", "PF-SR-SEED",
         "PF-BUCKET-ENCODE", "PF-BUCKET-DECODE", "PF-GUARD-TAINT",
         "PF-KV-WIRE", "HA-PAYLOAD-DTYPE", "HA-DOMAIN-COVERAGE",
         "HA-F32-RESIDUAL", "HA-WIRE-RATIO", "HA-F32-CONCAT", "HA-KV-DTYPE",
         "HA-KV-F32-CACHE", "KG-PREFETCH-ARITY", "KG-SMEM-TABLE",
         "KG-TILE-MIN", "KG-TILE-STRADDLE")


@pytest.fixture(scope="module")
def ref():
    out = run_reference([{"job": "analysis_cases", "tag": "a", "kw": {}}])
    return json.loads(str(out["a/cases"]))


# ---------------------------------------------------------------- flow cases

def _flow(fn):
    with Trace() as tr:
        fn()
    return flow.analyze_trace(tr)


def _a2a(x):
    return StackedTransport(N).all_to_all(x)


def _payload(x):
    return tagging.tag(x, "wire_payload", leg="dispatch")


def _bucket(encodes, after_decode):
    def f():
        g = torch.zeros(16)
        tagging.tag(g, "wire_bucket", stage="ready", bucket=0, leaf=0, n=1)
        for _ in range(encodes):
            tagging.tag(g.reshape(-1), "encode_in")
        dec = after_decode(tagging.tag(g * 0.5, "decode_out"))
        tagging.tag(dec, "wire_bucket", stage="mean", bucket=0, n=1)
    return f


def _guard(from_stats):
    def f():
        _a2a(_payload(torch.zeros(N, 32).to(torch.int8)))
        s = torch.zeros(())
        st = tagging.tag(s, "wire_stats") if from_stats else torch.zeros(())
        tagging.tag(st * 2.0, "guard_sink", domain="wire_grads")
    return f


def _flow_cases():
    z = torch.zeros
    tag = tagging.tag
    same = lambda d: d
    return {
        "PF-WIRE-F32/bad": lambda: _a2a(_payload(z(N, 32))),
        "PF-WIRE-F32/bad-untagged": lambda: (
            _a2a(_payload(z(N, 32).to(torch.int8))), _a2a(z(N, 32))),
        "PF-WIRE-F32/good": lambda: (
            _a2a(_payload(z(N, 32).to(torch.int8))),
            StackedTransport(N).psum(z(N))),
        "PF-REQUANT/bad": lambda: tag(
            tag(z(4, 8), "decode_out").reshape(-1)[:16], "encode_in",
            domain="wire_grads"),
        "PF-REQUANT/good": lambda: tag(
            tag(z(4, 8), "decode_out") * 0.5, "encode_in",
            domain="wire_grads"),
        "PF-STATS-ROUTE/bad": lambda: tag(
            tag(z(()), "wire_stats") + 1.0, "stats_sink", domain="grads",
            wire=False, stream="E"),
        "PF-STATS-ROUTE/good": lambda: tag(
            tag(z(()), "wire_stats") + 1.0, "stats_sink",
            domain="wire_grads", wire=True, stream="E"),
        "PF-SR-SEED/bad": lambda: tag(z(16, dtype=torch.int32), "sr_bits",
                                      domain="wire_grads"),
        "PF-SR-SEED/good": lambda: tag(ops.operand_bits(0, 16, "cpu"),
                                       "sr_bits", domain="wire_grads"),
        "PF-BUCKET-ENCODE/bad": _bucket(2, same),
        "PF-BUCKET-ENCODE/bad-dropped": _bucket(0, same),
        "PF-BUCKET-ENCODE/good": _bucket(1, same),
        "PF-BUCKET-DECODE/good": _bucket(1, same),
        "PF-BUCKET-DECODE/bad": _bucket(1, lambda d: d + 1.0),
        "PF-GUARD-TAINT/bad": _guard(False),
        "PF-GUARD-TAINT/good": _guard(True),
        "PF-KV-WIRE/bad": lambda: tag(z(4, 16), "kv_page", domain="kv_cache",
                                      stage="write", bits=8),
        "PF-KV-WIRE/good": lambda: tag(z(4, 16).to(torch.int8), "kv_page",
                                       domain="kv_cache", stage="write",
                                       bits=8),
    }


# ------------------------------------------------------------- audit cases

C2 = trace_audit.AuditClaims(engaged=("wire_grads",), two_leg=True,
                             n_wire_elems=4096)


def _audit(claims, *moves):
    """A trace of the given collectives on a stacked transport of N ranks
    (each a per-rank ``(op, dtype, elements)``), audited under ``claims``."""
    t = StackedTransport(N)
    with Trace() as tr:
        for op, dtype, n in moves:
            if op == "a2a":
                t.all_to_all(torch.zeros(N, n, dtype=dtype))
            elif op == "ag":          # n: the gathered (result) elements
                t.all_gather(torch.zeros(N, n // N, dtype=dtype))
            elif op == "ar":
                t.psum(torch.zeros(N, n, dtype=dtype))
            elif op == "cat":         # an fp32 flatten of two halves
                torch.cat([torch.zeros(n // 2), torch.zeros(n // 2)])
    return trace_audit.audit_trace(tr, claims)


A8, G8 = ("a2a", torch.int8, 4096), ("ag", torch.int8, 4096)
POOL = 4 * 64 * 16


def _decode(*tensors):
    with Trace() as tr:
        for t in tensors:
            t.clone()
    return trace_audit.audit_decode_trace(tr, pool_elems=POOL, bits=8)


def _audit_cases():
    both = dataclasses.replace(C2, engaged=("wire_grads", "wire_params"))
    i8 = torch.zeros(4, 64, 16, dtype=torch.int8)
    return {
        "HA-PAYLOAD-DTYPE/bad": lambda: _audit(
            C2, ("a2a", torch.float32, 4096), G8),
        "HA-PAYLOAD-DTYPE/bad-gather": lambda: _audit(C2, A8),
        "HA-PAYLOAD-DTYPE/good": lambda: _audit(C2, A8, G8),
        "HA-DOMAIN-COVERAGE/bad": lambda: _audit(
            dataclasses.replace(both, two_leg=False), A8),
        "HA-DOMAIN-COVERAGE/good": lambda: _audit(both, A8, G8),
        "HA-WIRE-RATIO/bad": lambda: _audit(
            C2, ("a2a", torch.int8, 65536), ("ag", torch.int8, 65536)),
        "HA-WIRE-RATIO/bad-thin": lambda: _audit(
            C2, ("a2a", torch.int8, 512), ("ag", torch.int8, 512)),
        "HA-WIRE-RATIO/good": lambda: _audit(C2, A8, G8),
        "HA-F32-RESIDUAL/bad": lambda: _audit(
            C2, A8, G8, ("ar", torch.float32, 4096)),
        "HA-F32-RESIDUAL/good": lambda: _audit(
            C2, A8, G8, ("ar", torch.float32, 8)),
        "HA-F32-CONCAT/bad": lambda: _audit(
            dataclasses.replace(C2, grouped=True), ("cat", None, 4096), A8,
            G8),
        "HA-F32-CONCAT/good": lambda: _audit(
            dataclasses.replace(C2, grouped=True), A8, G8),
        "HA-KV-DTYPE/bad": lambda: _decode(
            torch.zeros(4, 64, dtype=torch.int8)),
        "HA-KV-DTYPE/good": lambda: _decode(i8),
        "HA-KV-F32-CACHE/bad": lambda: _decode(i8, i8.to(torch.float32)),
        "HA-KV-F32-CACHE/good": lambda: _decode(i8),
    }


# ---------------------------------------------------------- geometry cases

def _geom():
    return ops.group_wire_call_geometry(8 * 4096, 4, 4096)


def _kg_cases():
    check = kernel_checks.check_call
    g = _geom()
    lay = collectives.group_layout((5000, 3000), n_chunks=8, quantum=4096)
    lcheck = kernel_checks.check_layout
    return {
        "KG-SMEM-TABLE/bad": lambda: check(
            dataclasses.replace(g, table_rows=5), expected_groups=4),
        "KG-SMEM-TABLE/bad-budget": lambda: check(
            dataclasses.replace(g, table_rows=20000),
            expected_groups=20000),
        "KG-SMEM-TABLE/good": lambda: check(g, expected_groups=4),
        # a call that passed one value to a 19-parameter entry
        "KG-PREFETCH-ARITY/bad": lambda: check(
            dataclasses.replace(g, args=(0,)), expected_groups=4),
        "KG-PREFETCH-ARITY/good": lambda: check(g, expected_groups=4),
        # the (32, 128) int8 tile's counterpart: whole warps
        "KG-TILE-MIN/bad": lambda: check(
            dataclasses.replace(g, threads=8), expected_groups=4),
        "KG-TILE-MIN/bad-quantum": lambda: check(
            dataclasses.replace(g, quantum=4096 + 8), expected_groups=4),
        "KG-TILE-MIN/good": lambda: check(g, expected_groups=4),
        "KG-TILE-STRADDLE/good": lambda: lcheck(lay),
        "KG-TILE-STRADDLE/bad": lambda: lcheck(
            dataclasses.replace(lay, offsets=(0, 5000))),
        "KG-TILE-STRADDLE/bad-padded": lambda: lcheck(
            dataclasses.replace(lay, padded=(4096, 4096))),
        "KG-TILE-STRADDLE/bad-chunk": lambda: lcheck(
            dataclasses.replace(lay, chunk=lay.chunk + 1)),
    }


CASES = {**{k: (_flow, v) for k, v in _flow_cases().items()},
         **{k: (None, v) for k, v in _audit_cases().items()},
         **{k: (None, v) for k, v in _kg_cases().items()}}


def _run(name):
    wrap, fn = CASES[name]
    return wrap(fn) if wrap is not None else fn()


def test_every_rule_has_a_broken_and_a_correct_case():
    rules = {k.split("/")[0] for k in CASES}
    assert rules == set(RULES)
    for r in RULES:
        assert f"{r}/good" in CASES and f"{r}/bad" in CASES


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_fires_as_the_reference_does(ref, name):
    """The port's report on its input fires exactly the rules the
    reference's report fires on the counterpart input; a broken case fires
    its rule, its closest correct case fires nothing, and the rule ran."""
    rule, kind = name.split("/")
    r = _run(name)
    assert list(r.rules_fired()) == ref[name]["fired"], r.summary()
    if kind == "good":
        assert r.ok, r.summary()
    else:
        assert rule in r.rules_fired(), r.summary()
    assert rule in r.checked


def test_sr_seed_takes_an_in_kernel_stream_and_the_plain_philox():
    """A ``Philox``/``GroupPhilox`` source is drawn in the kernel: tagged as
    the bits, it is a PRNG origin; so are the plain Philox words."""
    r = _flow(lambda: tagging.tag(Philox(7), "sr_bits"))
    assert r.ok and "PF-SR-SEED" in r.checked
    r = _flow(lambda: tagging.tag(dq.philox_bits(7, 64), "sr_bits"))
    assert r.ok
    r = _flow(lambda: tagging.tag(dq.philox_bits(7, 64) * 0, "sr_bits"))
    assert r.ok      # arithmetic keeps prng taint, as the reference's does


def _reduce_args(**over):
    """The values ``_dps_wire_reduce_cuda`` passes K4 for an (8, 4096)
    payload of four groups (addresses made up), with ``over`` replaced."""
    sig = _build.KERNEL_SIGNATURES["dps_wire_reduce"]
    plan = dq.reduce_plan(8, 4096, 4096, 8 * 4096, True)
    vals = dict(wire=1 << 40, row_stride=8 * 4096, n_ranks=8, chunk=4096,
                fmt_tab=(1 << 40) + 4096, tile_group=None, quantum=4096,
                out=(1 << 40) + 8192, nblocks=plan.blocks, body=1,
                span=plan.span, stages=plan.stages, stream=0)
    vals.update(over)
    return tuple(vals[a] for a in sig.args)


def test_prefetch_arity_checks_the_recorded_values():
    """A recorded call's values, held to their C types and its geometry: a
    count that does not fit the signature, an integer that ``ctypes`` would
    truncate, or a grid the builder does not give fires; NULL pointers and
    in-range values pass."""
    g = ops.wire_reduce_call_geometry(N, 4096, 4, 4096)
    check = lambda args: kernel_checks.check_call(
        dataclasses.replace(g, args=args), expected_groups=4)
    assert check(_reduce_args()).ok
    for bad in (_reduce_args()[:-1], _reduce_args(n_ranks=1 << 31),
                _reduce_args(row_stride=1 << 63), _reduce_args(wire=-16),
                _reduce_args(quantum=4096.0),
                _reduce_args(nblocks=g.grid[0] + 1)):
        assert check(bad).rules_fired() == ("KG-PREFETCH-ARITY",), bad


def test_builders_are_clean_and_the_library_binds_the_one_table(
        monkeypatch):
    for g in (ops.quantize_call_geometry(1 << 16),
              ops.quantize_call_geometry(100, wire=True),
              ops.quantize_call_geometry(1 << 16, block=True, groups=2),
              ops.group_wire_call_geometry(8 * 4096, 4, 4096),
              ops.wire_reduce_call_geometry(8, 4096, 4, 4096),
              ops.wire_reduce_call_geometry(8, 53885, 1, None),
              ops.paged_attn_call_geometry(8, 16, 513, 128, 8, 128, 24),
              *ops.bucketed_wire_call_geometries((5000, 300), 8, 1024)):
        assert kernel_checks.check_call(g).ok, g
    # the layouts' rank chunks share the kernels' 16-element vector
    assert dq.MIN_GROUP_QUANTUM == collectives.WIRE_CHUNK_ALIGN
    # the loaded library's argtypes come from the signature table (a stand-in
    # for the built library: every entry an attribute)
    import types
    entries = {}
    fake = lambda path: types.SimpleNamespace(
        **{e: entries.setdefault(e, types.SimpleNamespace())
           for e in (*_build.KERNEL_SIGNATURES,
                     "dps_quant_groups_per_thread", "cuda_error_string")})
    monkeypatch.setattr(_build, "build", lambda verbose=False: "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", fake)
    monkeypatch.setattr(_build, "_lib", None)
    _build.load()
    for entry, sig in _build.KERNEL_SIGNATURES.items():
        assert entries[entry].argtypes == [_build.CTYPES[k]
                                           for k in sig.kinds]
        assert len(sig.args) == len(sig.kinds)


def test_oversized_shared_memory_fires_against_the_card_budget():
    g = ops.wire_reduce_call_geometry(8, 4096, 4, 4096)
    r = kernel_checks.check_call(g, expected_groups=4,
                                 smem_budget=g.smem_bytes - 1)
    assert r.rules_fired() == ("KG-SMEM-TABLE",)


# ---------------------------------------------------------------- recorder

def test_recorder_follows_views_and_in_place_writes():
    def through_copy():
        d = tagging.tag(torch.ones(4, 8), "decode_out")
        y = torch.empty(32)
        y.copy_(d.t().reshape(-1))             # a view, then a copy_
        tagging.tag(y, "encode_in")
    assert "PF-REQUANT" in _flow(through_copy).rules_fired()

    def into_a_view():
        d = tagging.tag(torch.ones(8), "decode_out")
        buf = torch.zeros(16)
        buf[:8].copy_(d)                       # written through a view
        tagging.tag(buf, "encode_in")
    assert "PF-REQUANT" in _flow(into_a_view).rules_fired()

    def in_place_arithmetic():
        d = tagging.tag(torch.ones(8), "decode_out")
        d.mul_(0.5)                            # compute kills the taint
        tagging.tag(d, "encode_in")
    assert _flow(in_place_arithmetic).ok

    with Trace() as tr:
        x = torch.ones(4)
        x.add_(1.0)
    node = tr.of_kind("op", "add_")[0]
    assert id(x) in node.inputs and id(x) in node.outputs


def test_recorder_follows_the_backward_and_its_hooks():
    """Ops of the backward and of a post-accumulate-grad hook are recorded;
    a gradient landmark made in the hook reaches its encode."""
    w = torch.ones(4, 4, requires_grad=True)

    def hook(leaf):
        g = leaf.grad
        tagging.tag(g, "wire_bucket", stage="grad", bucket=0, n=1)
        tagging.tag(g, "wire_bucket", stage="ready", bucket=0, leaf=0, n=1,
                    rank=0)
        tagging.tag(g.reshape(-1), "encode_in")
        dec = tagging.tag(g * 0.5, "decode_out")
        tagging.tag(dec, "wire_bucket", stage="mean", bucket=0, n=1)

    h = w.register_post_accumulate_grad_hook(hook)
    try:
        with Trace() as tr:
            (w @ torch.ones(4, 2)).sum().backward()
    finally:
        h.remove()
    r = flow.analyze_trace(tr)
    assert r.ok and {"PF-BUCKET-ENCODE", "PF-BUCKET-DECODE"} <= set(r.checked)
    assert len(tr.of_kind("op", "mm")) >= 2      # forward and backward
    assert tr.of_kind("tag")


def test_tags_cost_nothing_without_a_trace():
    x = torch.ones(3)
    assert tagging.tag(x, "encode_in") is x
    assert tagging.tag_tree({"a": x}, "wire_stats")["a"] is x
    assert tagging.active() is None
    with Trace() as tr:
        assert tagging.active() is tr
    assert tagging.active() is None


def test_collectives_record_one_rank_s_bytes():
    t = StackedTransport(N)
    with Trace() as tr:
        t.all_to_all(torch.zeros(N, 64, dtype=torch.int8))
        t.all_gather(torch.zeros(N, 8, dtype=torch.int8))
        t.psum(torch.zeros(N, 3))
        t.gather_blocks([torch.zeros(2, 3) for _ in range(N)], 0)
        t.reduce_scatter_blocks([torch.zeros(16) for _ in range(N)], 0)
    w = trace_stats.collective_wire_bytes(tr)["by_op_dtype"]
    assert w == {"all-to-all": {"s8": 64.0}, "all-gather": {"s8": 64.0,
                                                            "f32": 192.0},
                 "all-reduce": {"f32": 24.0},
                 "reduce-scatter": {"f32": 64.0}}
    # the stacked gather is not an fp32 cat
    assert trace_stats.concat_bytes(tr)["count"] == 0
