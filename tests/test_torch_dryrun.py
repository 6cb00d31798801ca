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

The same job runs qwen3-moe, deepseek-v2 and mamba2, whose FLOPs are not
the reference's: each (config, kind) differs by a measured gap, written in
``FLOP_GAPS`` and derived from the configs' sizes below.  Most of it is
work that the port's placed steps repeat on every rank where XLA splits it
over the mesh (ROADMAP.md Queue 3): the MoE layer at decode, the MLA
down-projections, mamba2's B/C convolution and C·Bᵀ.
"""

import concurrent.futures
import json

import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_config, smoke
from repro_torch.launch import dryrun

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


def _mla_down(cfg, tokens):
    """The MLA down-projections (``wq_a``: D -> q_lora; ``wkv_a``: D ->
    kv_lora + rope) that every model rank runs over its data rank's
    ``tokens`` whole, where XLA splits them over the model axis."""
    width = cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_dim
    return (cfg.n_layers * 2 * tokens * cfg.d_model * width
            * (M_AXIS - 1) // M_AXIS)


def _moe_decode(cfg):
    """At decode (S = 1, which the model axis does not divide) the MoE
    layer takes the einsum dispatch, which the placed step runs whole on
    every rank: all B tokens, all E experts at capacity C, where XLA splits
    the dispatch, the experts and the combine over all d·m devices and the
    router over the data axis."""
    B, D, E, F = BATCH, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    C = 8       # ceil(B K / E x 1.25) = 3 slots, raised to 8 (8-aligned)
    split = 2 * E * C * B * D + 3 * 2 * E * C * D * F + 2 * B * E * C * D
    n = D_AXIS * M_AXIS
    return cfg.n_layers * (split * (n - 1) // n
                           + 2 * B * D * E * (D_AXIS - 1) // D_AXIS)


def _ssm_bc(cfg, tokens):
    """mamba2's B/C convolution and C·Bᵀ, which every model rank runs over
    the whole state (B and C are one group), where XLA splits them over
    the model axis: 2 T 2N K + 2 T Q N a layer."""
    N = cfg.ssm_state
    per = 2 * tokens * 2 * N * cfg.ssm_conv + 2 * tokens * cfg.ssm_chunk * N
    return cfg.n_layers * per * (M_AXIS - 1) // M_AXIS


def _derived_gaps():
    """FLOPs, the port's less the reference's dots, from the configs'
    sizes: a data rank holds BATCH / d rows, and a train or prefill step's
    MoE layer (the all-to-all dispatch) BATCH / d × SEQ / m tokens a rank."""
    rows = BATCH // D_AXIS
    q, s, m = (smoke(get_config(a)) for a in OTHERS)
    a2a_tokens = rows * SEQ // M_AXIS
    return {
        ("qwen3_moe_30b_a3b", "train"): _outer_bwd(q, a2a_tokens),
        ("qwen3_moe_30b_a3b", "prefill"): 0,
        ("qwen3_moe_30b_a3b", "decode"): _moe_decode(q),
        # the train step runs each down-projection forward and twice back
        ("deepseek_v2_236b", "train"): (3 * _mla_down(s, rows * SEQ)
                                        + _outer_bwd(s, a2a_tokens)),
        ("deepseek_v2_236b", "prefill"): _mla_down(s, rows * SEQ),
        ("deepseek_v2_236b", "decode"): _mla_down(s, rows) + _moe_decode(s),
        ("mamba2_1_3b", "prefill"): _ssm_bc(m, rows * SEQ),
        ("mamba2_1_3b", "decode"): 0,
    }


# the measured gaps (the port's FlopCounterMode count less the reference's
# HLO dot FLOPs).  mamba2's train step: per layer, the B/C convolution's
# forward and weight gradient and C·Bᵀ with its two gradients repeated
# over the model axis (5 x 12,288), plus the depthwise convolution's two
# input-gradient outer products the port counts (2 x 16,384), less three
# backward dots of 4,096 the reference has that the port computes
# elementwise: 81,920 a layer, not derived further
FLOP_GAPS = {
    ("qwen3_moe_30b_a3b", "train"): 8192,
    ("qwen3_moe_30b_a3b", "prefill"): 0,
    ("qwen3_moe_30b_a3b", "decode"): 1613824,
    ("deepseek_v2_236b", "train"): 1482752,
    ("deepseek_v2_236b", "prefill"): 491520,
    ("deepseek_v2_236b", "decode"): 1644544,
    ("mamba2_1_3b", "train"): 163840,
    ("mamba2_1_3b", "prefill"): 49152,
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
    configs' sizes derive (mamba2's train step aside)."""
    port, ref = cells
    _check_bytes(port[arch][kind], ref[arch], kind)
    gap = port[arch][kind]["flops"] - float(ref[arch][f"{kind}/dot_flops"])
    assert gap == FLOP_GAPS[arch, kind]
    derived = _derived_gaps()
    if (arch, kind) in derived:
        assert derived[arch, kind] == FLOP_GAPS[arch, kind]


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
