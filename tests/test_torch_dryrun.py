"""The port's per-rank dry run (``repro_torch.launch.dryrun``) against the
reference's compiled dry run.

At llama3.2-3b's smoke size on a (data 2, model 4) mesh, the reference's
``_compile_train``/``_compile_prefill``/``_compile_decode`` (``probe_unroll``
on, 8 forced host devices; job ``dryrun_cell``) give one device's
``argument_size_in_bytes`` and the FLOPs of the compiled HLO's ``dot(``
instructions.  The port runs the same steps (its placed train step, its
placed prefill and decode) once on ``meta`` tensors from rank 0's view of
the mesh.

* Bytes: prefill and decode equal the reference's to the byte.  The train
  step differs by 8 bytes, each accounted: the reference's state carries
  ``step`` as an int32 and ``rng`` as a uint32[2] key (4 + 8 bytes) where
  the port keeps a host integer each, and XLA drops ``last_loss`` from the
  compiled arguments (the step never reads it; 4 bytes the port holds).
* FLOPs: within 2 % of the reference's dot FLOPs; the measured gap is 0 in
  all three kinds (every matmul of the port's step is one of the
  reference's dots, forward and backward).

The same job runs qwen3-moe, deepseek-v2 and mamba2.  Their placed steps
split the work the way the reference's compiled steps split it (the MoE
layer at decode, MLA's down-projections, mamba2's B/C convolution and
C·Bᵀ), so their FLOPs are the reference's dots but for terms that are
counts, not work, written in ``FLOP_GAPS`` and derived from the configs'
sizes below: the top-k combine's backward outer product, and in mamba2's
train step the depthwise convolution's input-gradient outer products
(which XLA emits elementwise) less three backward dots of XLA's that the
port's autograd computes elementwise.  At decode no expert weight moves:
rank 0's collectives of the placed MoE layer are counted, payload by
payload.
"""

import concurrent.futures
import json

import pytest
import torch

from repro_torch.analysis.trace import Trace
from repro_torch.configs.base import ShapeConfig, get_config, smoke
from repro_torch.dist.sharding import LogicalRules, axis_rules, place_tensor
from repro_torch.launch import dryrun
from repro_torch.models import moe

from test_torch_jaxref import run_reference

KINDS = ("train", "prefill", "decode")
MESH = ((2, 4), ("data", "model"))
D_AXIS, M_AXIS = MESH[0]
SEQ, BATCH = 16, 8
FLOP_RTOL = 0.02
OTHERS = ("qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_1_3b")
TAGS = {"llama3_2_3b": "d", "qwen3_moe_30b_a3b": "q",
        "deepseek_v2_236b": "s", "mamba2_1_3b": "m"}


def _outer_bwd(cfg, tokens):
    """The top-k combine's backward for the gathered rows, an outer product
    (a contraction of length 1) that FlopCounterMode counts as a bmm and
    XLA emits as a multiply: 2 T K D a layer."""
    return cfg.n_layers * 2 * tokens * cfg.top_k * cfg.d_model


def _conv_counts(cfg, tokens):
    """mamba2's train step, a layer: the depthwise convolution's
    input-gradient outer products over each rank's (d_inner + 2N) / m
    channels (2 T K C / m, which FlopCounterMode counts as bmms and XLA
    emits as multiplies), less the three backward dots of the three-operand
    einsums that XLA emits and the port's autograd computes elementwise
    (y_inter's decay and C gradients, the chunk states' decay gradient:
    2 T (H / m) (2N + P))."""
    N, P, K = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
    di = cfg.ssm_expand * cfg.d_model
    H = di // P
    conv = 2 * tokens * K * (di + 2 * N) // M_AXIS
    return cfg.n_layers * (conv - 2 * tokens * (H // M_AXIS) * (2 * N + P))


def _derived_gaps():
    """FLOPs, the port's less the reference's dots, from the configs'
    sizes: a data rank holds BATCH / d rows, and a train step's MoE layer
    (the all-to-all dispatch) BATCH / d × SEQ / m tokens a rank."""
    rows = BATCH // D_AXIS
    q, s, m = (smoke(get_config(a)) for a in OTHERS)
    a2a_tokens = rows * SEQ // M_AXIS
    gaps = {(a, k): 0 for a in OTHERS for k in KINDS}
    gaps.update({
        ("qwen3_moe_30b_a3b", "train"): _outer_bwd(q, a2a_tokens),
        ("deepseek_v2_236b", "train"): _outer_bwd(s, a2a_tokens),
        ("mamba2_1_3b", "train"): _conv_counts(m, rows * SEQ),
    })
    return gaps


# the measured gaps (the port's FlopCounterMode count less the reference's
# HLO dot FLOPs); every one is derived above
FLOP_GAPS = {
    ("qwen3_moe_30b_a3b", "train"): 8192,
    ("qwen3_moe_30b_a3b", "prefill"): 0,
    ("qwen3_moe_30b_a3b", "decode"): 0,
    ("deepseek_v2_236b", "train"): 8192,
    ("deepseek_v2_236b", "prefill"): 0,
    ("deepseek_v2_236b", "decode"): 0,
    ("mamba2_1_3b", "train"): 16384,
    ("mamba2_1_3b", "prefill"): 0,
    ("mamba2_1_3b", "decode"): 0,
}


@pytest.fixture(scope="module")
def cells():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    jobs = [{"job": "dryrun_cell", "tag": TAGS[arch], "kw": {
        "arch": arch, "kinds": list(KINDS), "seq": SEQ, "batch": BATCH,
        "mesh": list(MESH[0])}} for arch in TAGS]
    fut = pool.submit(run_reference, jobs, None, 900, 8, True)
    pool.shutdown(wait=False)
    port = {}
    for arch in TAGS:
        cfg = smoke(get_config(arch))
        port[arch] = {k: dryrun.run_cell(
            arch, None, cfg=cfg, shape=ShapeConfig(f"smoke_{k}", k, SEQ,
                                                   BATCH),
            mesh_shape=MESH) for k in KINDS}
    ref = fut.result()
    return port, {arch: {k[len(t) + 1:]: v for k, v in ref.items()
                         if k.startswith(t + "/")}
                  for arch, t in TAGS.items()}


def _params(ref, kind):
    return {name.replace("\\'", "'"): n
            for name, n in json.loads(str(ref[f"{kind}/params"]))}


def _check_bytes(p, ref, kind):
    ref_bytes = int(ref[f"{kind}/argument_bytes"])
    # the held blocks are the placement's promise, to the byte
    assert p["state_bytes"] + p["batch_bytes"] == p["spec_bytes"]
    params = _params(ref, kind)
    assert sum(params.values()) == ref_bytes
    if kind != "train":
        assert p["spec_bytes"] == ref_bytes
        return
    assert params["state.step"] == 4 and params["state.rng"] == 8
    assert "state.last_loss" not in params
    last_loss = 4
    assert ref_bytes == p["spec_bytes"] - last_loss + 4 + 8


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_match_the_reference(cells, kind):
    port, ref = cells
    _check_bytes(port["llama3_2_3b"][kind], ref["llama3_2_3b"], kind)


@pytest.mark.parametrize("kind", KINDS)
def test_flops_within_two_percent_of_the_reference_dots(cells, kind):
    port, ref = cells
    ref_flops = float(ref["llama3_2_3b"][f"{kind}/dot_flops"])
    flops = port["llama3_2_3b"][kind]["flops"]
    gap = abs(flops - ref_flops) / ref_flops
    assert gap <= FLOP_RTOL, (flops, ref_flops)
    assert gap == 0.0       # measured: every port matmul is a reference dot


@pytest.mark.parametrize("arch", OTHERS)
@pytest.mark.parametrize("kind", KINDS)
def test_other_families_bytes_and_measured_flop_gaps(cells, arch, kind):
    """The same bytes as the reference's (the same accounting as llama's),
    and the FLOPs the reference's dots plus the measured gap, which the
    configs' sizes derive: counts, not work."""
    port, ref = cells
    _check_bytes(port[arch][kind], ref[arch], kind)
    gap = port[arch][kind]["flops"] - float(ref[arch][f"{kind}/dot_flops"])
    assert gap == FLOP_GAPS[arch, kind]
    assert _derived_gaps()[arch, kind] == FLOP_GAPS[arch, kind]


def test_collectives_are_counted_from_one_rank():
    """The placed train step's traffic on rank 0: FSDP's all-gathers and
    reduce-scatters and the tensor-parallel sums, fp32 at smoke size, and
    nothing on an int8 wire (the wire does not engage with a model
    axis)."""
    cfg = smoke(get_config("llama3_2_3b"))
    out = dryrun.run_cell("llama3_2_3b", None, cfg=cfg,
                          shape=ShapeConfig("t", "train", SEQ, BATCH),
                          mesh_shape=MESH)
    w = out["collective_wire_bytes"]
    assert set(w) >= {"all-gather", "reduce-scatter", "all-reduce"}
    assert out["collective_summary"]["int8"] == 0.0
    assert all(v > 0 for d in w.values() for v in d.values())


def _moe_decode_collectives(cfg):
    """Rank 0's collectives of the placed MoE layer at decode (B, 1, D) on
    the (2, 4) mesh, on meta tensors: ``(op, dtype, payload bytes, takes
    an expert weight's block)`` each."""
    mesh, rules = dryrun.OneRankMesh(*MESH), LogicalRules()
    D = cfg.d_model
    with torch.device("meta"), axis_rules(mesh, rules):
        p = {k: place_tensor(torch.empty(d.shape, dtype=d.dtype),
                             rules.spec(d.logical, d.shape, mesh), mesh)
             for k, d in moe.moe_defs(cfg, torch.float32).items()}
        x = place_tensor(torch.empty(BATCH, 1, D),
                         rules.spec(("batch", None, None), (BATCH, 1, D),
                                    mesh), mesh)
        with Trace(ops=False) as tr, torch.no_grad():
            moe.moe_apply(cfg, p, x)
    experts = {id(b) for k in ("w_in", "w_gate", "w_out")
               for b in p[k].blocks}
    return [(n.name, n.meta["dtype"], n.meta["nbytes"],
             bool(experts & set(n.inputs)))
            for n in tr.of_kind("collective")]


def test_placed_moe_decode_gathers_no_expert_weight():
    """qwen3-moe's MoE layer at decode (S = 1 fails the all-to-all gate):
    rank 0's collectives, counted payload by payload.  Split as the
    reference's compiled step splits it, no collective takes an expert
    weight: the load-balance ingredients' mean (over model, then data),
    the top-k indices gathered over data (B·K int32), the dispatch
    buffers reduce-scattered over data onto the weights' split of D, the
    experts' hidden sums over it, their outputs gathered over it, the
    combined rows summed over the model axis."""
    cfg = smoke(get_config("qwen3_moe_30b_a3b"))
    got = _moe_decode_collectives(cfg)
    E, K, D, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    rows, e_l, f32 = BATCH // D_AXIS, cfg.n_experts // M_AXIS, 4
    C = moe._capacity(BATCH, cfg)       # the global token count's
    mean = [("all-gather", "f32", M_AXIS * E * f32, False),
            ("all-gather", "f32", D_AXIS * E * f32, False)]
    assert got == mean + mean + [
        ("all-gather", "s32", D_AXIS * rows * K * 4, False),
        ("reduce-scatter", "f32", e_l * C * D * f32, False),
        ("all-reduce", "f32", e_l * C * F * f32, False),
        ("all-reduce", "f32", e_l * C * F * f32, False),
        ("all-gather", "f32", D_AXIS * e_l * C * D // D_AXIS * f32, False),
        ("all-reduce", "f32", rows * D * f32, False)]


def test_one_rank_mesh_allocates_nothing_and_holds_rank_zero():
    mesh = dryrun.OneRankMesh(*MESH)
    assert mesh.size() == 8 and mesh.size(1) == 4
    assert mesh.get_coordinate() == [0, 0]
    t = mesh.transport("model")
    x = torch.empty((1, 8), device="meta")
    assert tuple(t.all_to_all(x).shape) == (1, 4, 2)
    assert tuple(t.all_gather(x).shape) == (32,)
    g = t.gather_blocks([torch.empty((3, 2), device="meta")], 0)[0]
    assert g.is_meta and tuple(g.shape) == (12, 2)


def test_full_size_cell_and_cli(tmp_path, capsys):
    """A production cell at full size (no tensor is allocated) through the
    CLI, written to ``--out``."""
    rc = dryrun.main(["--arch", "llama3_2_3b", "--shape", "decode_32k",
                      "--mesh", "multi", "--out", str(tmp_path)])
    assert rc == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")][0]
    stats = json.loads(line)
    assert stats["n_devices"] == 512 and stats["flops"] > 0
    assert stats["state_bytes"] + stats["batch_bytes"] == stats["spec_bytes"]
    assert (tmp_path / "llama3_2_3b__decode_32k__multi.json").exists()
