"""Grid parity of the port's lint with the reference's: LeNet's baseline,
tree, per-layer and zero cells, and tree / per-layer with the overlapped
wire (``--wire-overlap on``); ``tests/test_torch_lint_zero.py`` holds the
rest of the grid.

Each cell runs here on the CPU (the kernels' plain versions) on a stacked
data mesh of 8 ranks, and the reference's ``lint_cell`` runs it in one child
over 8 forced host devices (job ``lint``), side by side with the port's
work.  Per cell: every pass kind the reference reports (``/flow``,
``/hlo`` <-> ``/trace``, ``/pipeline``, ``/kernel/{layout,encode,reduce}``)
checks the same rule IDs in both packages, no report has a violation, and
the int8 ring-model bytes per collective op that the port's trace counts
equal the reference's compiled-HLO ``collective_wire_bytes`` — to the byte
in LeNet's zero, per-layer and zero-per-layer cells.  In tree and the
overlapped cells they do not: they differ by a measured gap a leg, written
here (``LEG_GAPS``) and derived independently of either package's code
from the two layouts' rounding (:func:`one_format_leg`,
:func:`per_leaf_leg`): the port rounds a one-format rank chunk up to 16
elements, K4's vector, where the reference does not round it, and pads a
per-leaf bucket's leaves to a quantum on 16 elements where the
reference's CPU codec pads on 128 lanes.

The port's cells run on one thread: its eight ranks' small ops run many
times slower on a thread pool that competes with the reference's child and
the other workers for the cores.
"""

import concurrent.futures
import json
import math

import pytest
import torch

from repro_torch.analysis import lint
from repro_torch.dist import overlap as ov

from test_torch_jaxref import one_thread, run_reference  # noqa: F401

N = 8
CELLS = [("lenet", "baseline", False), ("lenet", "tree", False),
         ("lenet", "per-layer", False), ("lenet", "zero", False),
         ("lenet", "tree", True), ("lenet", "per-layer", True)]
# the LeNet leaves' sizes, in flatten order
LENET_LEAVES = (20, 500, 50, 25000, 500, 400000, 10, 5000)
# the overlapped wire's buckets of them (leaf indices; 65,536-element
# buckets, both packages' plan)
LENET_BUCKETS = ((6, 7), (5,), (0, 1, 2, 3, 4))
# int8 bytes a leg (all-to-all and all-gather alike), the port's less the
# reference's, as measured: tree +24 (rank chunks of 53,888 against
# 53,885); tree overlapped +104 + 0 + 40 (its three buckets' chunks of
# 640 / 50,000 / 3,264 against 627 / 50,000 / 3,259); per-layer overlapped
# -384 (bucket (6, 7) at a 2,512-element quantum, 20,096 a leg, against
# 2,560, 20,480); every other cell 0
LEG_GAPS = {("lenet", "tree", False): 24, ("lenet", "tree", True): 144,
            ("lenet", "per-layer", True): -384}


def _up(x, m):
    return -(-x // m) * m


def one_format_leg(size):
    """(port, reference) int8 elements of one leg of a one-format payload
    of ``size`` elements: rank chunks of ``ceil(size / N)``, the port's
    rounded up to 16 elements."""
    c = -(-size // N)
    return N * _up(c, 16), N * c


def per_leaf_leg(sizes):
    """(port, reference) int8 elements of one leg of a per-leaf-format run
    of leaves of ``sizes``: each leaf padded to the quantum ``ceil(total /
    G)`` (at most 4,096), the port's rounded up to 16 elements, the
    reference's CPU codec's to 128 lanes; rank chunks of whole quanta."""
    def leg(lane):
        q = min(4096, _up(-(-sum(sizes) // len(sizes)), lane))
        return N * q * -(-sum(_up(s, q) for s in sizes) // (N * q))
    return leg(16), leg(128)


def derived_leg_gap(mode, overlap):
    """The gap a leg from the layouts' arithmetic alone."""
    runs = LENET_BUCKETS if overlap else (tuple(range(len(LENET_LEAVES))),)
    gap = 0
    for run in runs:
        sizes = [LENET_LEAVES[g] for g in run]
        if mode == "tree":
            port, ref = one_format_leg(sum(sizes))
        elif mode == "per-layer" and overlap:
            port, ref = per_leaf_leg(sizes)
        else:
            port = ref = 0
        gap += port - ref
    return gap


def cell_id(cell):
    config, mode, overlap = cell
    return f"{config}/{mode}" + ("+overlap" if overlap else "")


def start_reference(cells):
    """The reference's lint of ``cells`` in one child, in a thread: the
    port's cells run meanwhile."""
    jobs = [{"job": "lint", "tag": "lint", "kw": {
        "cells": [[c, m, o, False] for c, m, o in cells]}}]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_reference, jobs, None, 900, 8, True)
    pool.shutdown(wait=False)
    return fut


def run_port(cells):
    """The port's cells, on one thread: eight ranks' small ops, beside the
    reference's child and other workers, run many times slower on a
    thread pool that competes for the cores."""
    out = {}
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for cell in cells:
            config, mode, overlap = cell
            wb = {}
            reps = lint.lint_cell(config, mode, N, "cpu",
                                  wire_overlap=overlap, wire_bytes=wb)
            out[cell] = ({r.name: r for r in reps}, wb)
    finally:
        torch.set_num_threads(saved)
    return out


def ref_cell(out, cell):
    config, mode, overlap = cell
    key = f"lint/{config}/{mode}/{int(overlap)}0"
    return (json.loads(str(out[key + "/reports"])),
            json.loads(str(out[key + "/bytes"])),
            int(out[key + "/padded"]) if key + "/padded" in out else None)


def pass_kind(name, cell):
    """A report's pass, its cell's prefix taken off (``hlo`` is ``trace``);
    None for the port's own reports (its launches, a degraded step)."""
    config = cell[0]
    prefix = f"{'llama3_2_3b' if cell[1] == 'serve-decode' else config}/" \
             f"{cell[1]}/"
    kind = name[len(prefix):]
    if kind.startswith(("kernel/launches", "launches", "degraded")):
        return None
    return "trace" if kind == "hlo" else kind


def check_rules(port_reps, ref_reps, cell):
    port = {pass_kind(n, cell): r for n, r in port_reps.items()
            if pass_kind(n, cell) is not None}
    ref = {pass_kind(n, cell): r for n, r in ref_reps.items()}
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for kind, r in port.items():
        assert sorted(r.checked) == ref[kind]["checked"], kind
        assert r.ok, r.summary()
        assert ref[kind]["fired"] == [], kind
    for r in port_reps.values():            # the port's own reports too
        assert r.ok, r.summary()


def int8_bytes(by_op):
    return {op: d["s8"] for op, d in by_op.items() if d.get("s8")}


def check_bytes(port_wb, ref_bytes, cell, expected_gap=None):
    """The int8 bytes per op of the cell's step: equal, or (``expected_gap``
    a dict op -> bytes) port = reference + the accounted gap."""
    name = f"{cell[0]}/{cell[1]}"
    port = int8_bytes(port_wb[name]["by_op_dtype"])
    ref = int8_bytes(ref_bytes[f"{name}/hlo"])
    gap = expected_gap or {}
    assert set(port) == set(ref), (port, ref)
    for op in ref:
        assert port[op] - ref[op] == gap.get(op, 0.0), (op, port, ref)


@pytest.fixture(scope="module")
def grid():
    fut = start_reference(CELLS)
    port = run_port(CELLS)
    return port, fut.result()


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_same_rules_checked_and_none_fired(grid, cell):
    port, ref = grid
    check_rules(port[cell][0], ref_cell(ref, cell)[0], cell)


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] != "baseline"],
                         ids=cell_id)
def test_int8_wire_bytes_match_the_reference(grid, cell):
    port, ref = grid
    _, ref_bytes, _ = ref_cell(ref, cell)
    config, mode, overlap = cell
    d = LEG_GAPS.get(cell, 0)
    assert derived_leg_gap(mode, overlap) == d
    check_bytes(port[cell][1], ref_bytes, cell,
                {"all-to-all": d, "all-gather": d})


def test_overlapped_buckets_are_the_planned_ones():
    assert ov.plan_buckets(LENET_LEAVES).buckets == LENET_BUCKETS


def test_zero_bytes_are_the_flat_layout_on_both_legs(grid):
    """ZeRO-1 over the plain layout: both legs carry the ``ceil(size /
    n)`` shards exactly, in both packages."""
    port, _ = grid
    w = port[("lenet", "zero", False)][1]["lenet/zero"]["by_op_dtype"]
    shard = math.ceil(sum(LENET_LEAVES) / N)
    assert w["all-to-all"]["s8"] == w["all-gather"]["s8"] == N * shard


def test_guarded_cell_audits_the_clean_and_the_degraded_step(one_thread):
    """``--guards``: the clean step proves PF-GUARD-TAINT; the NaN drill's
    degraded step (the fp32 fallback) is audited against its own claims,
    with no int8 payload on the fallen-back leg."""
    reps = {r.name: r for r in lint.lint_cell("lenet", "tree", N, "cpu",
                                              guards=True)}
    assert all(r.ok for r in reps.values()), [r.summary() for r in
                                               reps.values()]
    assert "PF-GUARD-TAINT" in reps["lenet/tree/flow"].checked
    deg = reps["lenet/tree/degraded/trace"]
    assert {"HA-DOMAIN-COVERAGE", "HA-F32-RESIDUAL"} <= set(deg.checked)


def test_cli_exit_codes(monkeypatch, capsys, one_thread):
    assert lint.main(["--device", "cpu", "--modes", "baseline"]) == 0
    assert "CLEAN" in capsys.readouterr().out
    from repro_torch.analysis import flow
    real = flow.analyze_trace

    def broken(tr, name="step"):
        r = real(tr, name)
        r.add("PF-WIRE-F32", "injected", name)
        return r
    monkeypatch.setattr(flow, "analyze_trace", broken)
    assert lint.main(["--device", "cpu", "--modes", "baseline"]) == 1
    assert "1 violation(s)" in capsys.readouterr().out
