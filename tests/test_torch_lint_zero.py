"""Grid parity of the port's lint with the reference's, second half: LeNet's
zero-per-layer and zero-overlap cells, the serving decode cell, and
llama3.2-3b at smoke size under the tree and zero-per-layer modes (see
``tests/test_torch_lint.py`` for what each cell checks).

The overlapped ZeRO layout pads each bucket's groups to a quantum that the
two packages round differently (the port to 16 elements, the reference's
jnp codec to 128 lanes), and llama's tree cell rounds its rank chunks as
LeNet's does: their int8 bytes differ from the reference's by a measured
gap a leg (``LEG_GAPS``), derived from the layouts' arithmetic alone
(``test_torch_lint.one_format_leg``/``per_leaf_leg``).
"""

import pytest

from repro_torch.core import qtrain

from test_torch_lint import (LENET_BUCKETS, LENET_LEAVES, N, cell_id,
                             check_bytes, check_rules, one_format_leg,
                             per_leaf_leg, ref_cell, run_port,
                             start_reference)

CELLS = [("lenet", "zero-per-layer", False), ("lenet", "zero-overlap", False),
         ("lenet", "serve-decode", False), ("llama3_2_3b", "tree", False),
         ("llama3_2_3b", "zero-per-layer", False)]
# the smoke llama3.2-3b's parameters, both packages' count
LLAMA_SMOKE_PARAMS = 94528
# int8 bytes a leg, the port's less the reference's, as measured:
# zero-overlap -384 (bucket (6, 7) at a 2,512-element quantum, 20,096 a
# leg, against 2,560, 20,480); llama tree +64 (rank chunks of 11,824
# against 11,816); the zero-per-layer cells 0
LEG_GAPS = {("lenet", "zero-overlap", False): -384,
            ("llama3_2_3b", "tree", False): 64}
# each package's flat layout of the ZeRO cells' legs, from the layouts'
# arithmetic: (port, reference)
LENET_ZERO_LEGS = {
    "zero-per-layer": per_leaf_leg(LENET_LEAVES),
    "zero-overlap": tuple(map(sum, zip(*(
        per_leaf_leg([LENET_LEAVES[g] for g in run])
        for run in LENET_BUCKETS))))}


@pytest.fixture(scope="module")
def grid():
    fut = start_reference(CELLS)
    port = run_port(CELLS)
    return port, fut.result()


def _port_padded(config, mode):
    from repro_torch.analysis import lint
    qcfg = lint._mode_qcfg(mode, N, "flexpoint")
    if config == "lenet":
        from repro_torch.models import lenet
        params = lenet.init(0)
        if "per-layer" in mode:
            qcfg = qcfg.with_per_layer_wire(params)
    else:
        from repro_torch.configs.base import get_config, smoke
        from repro_torch.launch import specs
        cfg = smoke(get_config(config))
        if "per-layer" in mode:
            qcfg = specs.per_layer_wire_qcfg(cfg, qcfg)
        params = specs.abstract_train_state(
            cfg, lint_optimizer(), qcfg).params
    return qtrain.zero_partitioner(qcfg, params, N).padded_size


def lint_optimizer():
    from repro_torch.optim import SGDConfig, make_optimizer
    return make_optimizer(SGDConfig())


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_same_rules_checked_and_none_fired(grid, cell):
    port, ref = grid
    check_rules(port[cell][0], ref_cell(ref, cell)[0], cell)


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if c[1] != "serve-decode"], ids=cell_id)
def test_int8_wire_bytes_match_the_reference(grid, cell):
    port, ref = grid
    _, ref_bytes, ref_padded = ref_cell(ref, cell)
    config, mode, _ = cell
    d = LEG_GAPS.get(cell, 0)
    if config == "lenet":
        # each leg carries its package's flat layout exactly
        port_leg, ref_leg = LENET_ZERO_LEGS[mode]
        assert port_leg - ref_leg == d
        assert ref_padded == ref_leg
        assert _port_padded(config, mode) == port_leg
        w = port[cell][1][f"{config}/{mode}"]["by_op_dtype"]
        assert w["all-to-all"]["s8"] == port_leg
    elif mode == "tree":
        assert _llama_smoke_params() == LLAMA_SMOKE_PARAMS
        port_leg, ref_leg = one_format_leg(LLAMA_SMOKE_PARAMS)
        assert port_leg - ref_leg == d
    check_bytes(port[cell][1], ref_bytes, cell,
                {"all-to-all": d, "all-gather": d})


def _llama_smoke_params():
    from repro_torch.configs.base import get_config, smoke
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import specs
    st = specs.abstract_train_state(smoke(get_config("llama3_2_3b")),
                                    lint_optimizer(),
                                    qtrain.QuantConfig())
    return sum(l.numel() for l in tree_lib.leaves(st.params))


def test_lenet_zero_per_layer_bytes_are_equal(grid):
    """Per-leaf formats run the group-aligned layout at the same quantum in
    both packages: the bytes are equal, no gap."""
    port, ref = grid
    cell = ("lenet", "zero-per-layer", False)
    assert _port_padded("lenet", "zero-per-layer") == ref_cell(ref, cell)[2]
