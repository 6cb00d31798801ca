"""The four DPS controllers of the training slice against the JAX package.

``PaperController`` (the paper's Algorithm 2), ``CourbariauxController``,
``NaController`` and ``StaticController`` are driven by one shared 50-step
sequence of statistics and losses made with numpy, in both packages.  Held:
the integer ⟨IL, FL⟩ trajectories identical, step for step.  The sequence
puts the overflow rate and the quantization error on both sides of their
thresholds, plateaus the loss so the Na & Mukhopadhyay width bumps fire, and
runs narrow enough that the clamps (IL/FL bounds, the fp32 exactness span,
the width cap) bind.  (FlexPoint is held in ``test_torch_fixed_point.py``.)
"""

import numpy as np
import pytest
import torch

from repro_torch.core import dps
from repro_torch.core.fixed_point import QuantStats
from test_torch_jaxref import STAT_NAMES, run_reference

NAMES = ("paper", "courbariaux", "na_mukhopadhyay", "static")
T = 50
_rng = np.random.default_rng(21)


def _sequence():
    count = _rng.integers(500, 5000, T).astype(np.float32)
    nonzero = np.floor(count * _rng.uniform(0.5, 1.0, T)).astype(np.float32)
    # overflow rates of 0, well under r_max/2, and well over r_max
    rate = _rng.choice([0.0, 2e-5, 1e-3, 5e-3], T, p=[0.4, 0.2, 0.25, 0.15])
    overflow = np.round(count * rate).astype(np.float32)
    # mean relative errors at a tenth to ten times e_max (never on it)
    err = 1e-4 * 10.0 ** _rng.choice([-1.0, -0.5, 0.5, 1.0], T)
    rel = (nonzero * err).astype(np.float32)
    abs_sum = (nonzero * _rng.uniform(0.1, 2, T)).astype(np.float32)
    abs_err = (abs_sum * err).astype(np.float32)
    max_abs = _rng.uniform(0.5, 40, T).astype(np.float32)
    # loss falls, then sits on a plateau (the Na stall), then falls again
    loss = np.concatenate([np.linspace(3, 2, 15), np.full(20, 2.0),
                           np.linspace(2, 1, 15)]).astype(np.float32)
    return {"count": count, "nonzero": nonzero, "overflow": overflow,
            "abs_err_sum": abs_err, "rel_err_sum": rel, "abs_sum": abs_sum,
            "max_abs": max_abs, "loss": loss}


SEQ = _sequence()
HYPERS = {
    "default": {"na_window": 5},
    # narrow bounds and a low width cap: the clamps bind
    "tight": {"il_min": 3, "il_max": 6, "fl_min": 2, "fl_max": 9,
              "il_init": 5, "fl_init": 8, "max_total": 12, "total_bits": 10,
              "na_tl_init": 6, "na_ml": 9, "na_window": 3, "step": 2},
}


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "controllers", "tag": tag,
             "kw": {"names": list(NAMES), "hyper": h}}
            for tag, h in HYPERS.items()]
    arrays = {f"{tag}/{k}": v for tag in HYPERS for k, v in SEQ.items()}
    return run_reference(jobs, arrays)


def _run(name, hyper):
    ctrl = dps.make_controller(name, dps.DPSHyper(**hyper))
    st = ctrl.init()
    ils, fls = [st.il.numpy().copy()], [st.fl.numpy().copy()]
    for t in range(T):
        stats = QuantStats(*(torch.tensor(SEQ[k][t]) for k in STAT_NAMES))
        st = ctrl.update(st, stats, {"loss": torch.tensor(SEQ["loss"][t])})
        assert st.il.dtype == torch.int32 and st.fl.dtype == torch.int32
        ils.append(st.il.numpy().copy())
        fls.append(st.fl.numpy().copy())
    return np.stack(ils), np.stack(fls)


@pytest.mark.parametrize("tag", sorted(HYPERS))
@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_reference(ref, name, tag):
    il, fl = _run(name, HYPERS[tag])
    np.testing.assert_array_equal(il, ref[f"{tag}/{name}/il"])
    np.testing.assert_array_equal(fl, ref[f"{tag}/{name}/fl"])


def test_the_sequence_moves_every_dynamic_controller(ref):
    """Guard against a vacuous comparison: each dynamic controller changes
    its format both ways over the sequence, and Na widens."""
    for name in ("paper", "courbariaux"):
        d = np.diff(ref[f"default/{name}/il"])
        assert (d > 0).any() and (d < 0).any(), name
    tl = ref["default/na_mukhopadhyay/il"] + ref["default/na_mukhopadhyay/fl"]
    assert tl[-1] > tl[0]
    assert len(set(ref["default/static/il"].tolist())) == 1


def test_controllers_run_per_group_on_device_tensors():
    """A [G] state updates elementwise with no host read."""
    G = 3
    for name in NAMES:
        ctrl = dps.make_controller(name)
        st = ctrl.init((G,))
        z = torch.zeros(G)
        stats = QuantStats(z + 100, z + 100, torch.tensor([0.0, 1.0, 50.0]),
                           z, torch.tensor([0.0, 1.0, 5.0]), z + 1, z + 1)
        st = ctrl.update(st, stats, {"loss": torch.tensor(1.0)})
        assert tuple(st.il.shape) == (G,) and tuple(ctrl.fmt(st).fl.shape) == (G,)
