"""The paper's fixed-width ablations in the port against the JAX package's.

``apps.mnist.paper_quant_config(static_bits=..., static_scope=...,
na_window=...)`` builds the configs of the paper's Fig. 4 (the naive fixed
13-bit run) and of Gupta et al.'s 16-bit runs (narrow weights only) under
the ``"static"`` controller; without ``static_bits`` the adaptive config
takes ``na_window``.  Held:

* every field the config sets — the controller, rounding, statistics scope
  and each domain's ``DPSHyper`` — equal to the reference's, at 13 and 16
  bits under both scopes and at ``na_window`` 5 and 30;
* 5 LeNet steps under nearest rounding of fixed 13-bit and of Gupta-16
  (``static_bits=16, static_scope="weights"``) from the reference's
  converted parameters: ⟨IL, FL⟩ of every domain identical at every step
  (and the static ones, never moving), the loss to 1e-4 relative, as
  ``tests/test_torch_train.py`` holds the adaptive run.

Also: ``launch.paper_eval`` runs Fig. 4's three arms from one
initialization on the CPU and takes the bench's claims over them.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro_torch.apps import mnist as app
from repro_torch.convert import lenet_params_from_jax
from repro_torch.data import MNISTLike
from repro_torch.launch import paper_eval
from test_torch_jaxref import run_reference, unflatten

CASES = {"static13_all": dict(static_bits=13),
         "static13_weights": dict(static_bits=13, static_scope="weights"),
         "static16_all": dict(static_bits=16),
         "static16_weights": dict(static_bits=16, static_scope="weights"),
         "na_window5": dict(na_window=5),
         "na_window30": dict(na_window=30)}
RUNS = {"fixed13": dict(steps=5, n_train=256, qkw={"static_bits": 13}),
        "gupta16": dict(steps=5, n_train=256,
                        qkw={"static_bits": 16, "static_scope": "weights"})}
# the formats each static run holds: (IL, FL) of weights, acts, grads
STATIC_FMTS = {"fixed13": ((2, 11), (8, 5), (6, 7)),
               "gupta16": ((2, 14), (8, 8), (6, 18))}
FMTS = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    jobs = [{"job": "paper_config", "tag": "cfg", "kw": {"cases": CASES}}]
    jobs += [{"job": "lenet_train", "tag": name, "kw": kw}
             for name, kw in RUNS.items()]
    return run_reference(jobs)


def _fields(q):
    return {"enabled": q.enabled, "controller": q.controller,
            "rounding": q.rounding, "stat_scope": q.stat_scope,
            **{h: dataclasses.asdict(getattr(q, h)) for h in
               ("hyper_weights", "hyper_acts", "hyper_grads")}}


@pytest.mark.parametrize("case", CASES)
def test_paper_quant_config_fields_match_reference(ref, case):
    got = json.loads(json.dumps(_fields(app.paper_quant_config(**CASES[case]))))
    assert got == json.loads(str(ref[f"cfg/{case}"]))
    want_controller = "static" if "static_bits" in CASES[case] else "paper"
    assert got["controller"] == want_controller
    assert got["stat_scope"] == "last_layer"


@pytest.mark.parametrize("run", RUNS)
def test_static_lenet_steps_match_reference(ref, run):
    kw = RUNS[run]
    params = lenet_params_from_jax(unflatten(ref, f"{run}/params/"), "cpu")
    data = MNISTLike(batch=64, seed=0, n_train=kw["n_train"], n_test=64)
    hist = app.train_mnist(app.paper_quant_config(rounding="nearest",
                                                  **kw["qkw"]),
                           steps=kw["steps"], data=data, device="cpu",
                           params=params)
    for k in FMTS:
        np.testing.assert_array_equal(np.asarray(hist[k], np.float64),
                                      ref[f"{run}/hist/{k}"], err_msg=k)
    np.testing.assert_allclose(hist["loss"], ref[f"{run}/hist/loss"],
                               rtol=LOSS_RTOL)
    # the static controller never moves a format
    for (il, fl), d in zip(STATIC_FMTS[run], "wag"):
        assert set(hist[f"il_{d}"]) == {il} and set(hist[f"fl_{d}"]) == {fl}
    assert all(np.isfinite(hist["loss"]))


def test_paper_eval_runs_the_three_arms_from_one_initialization(capsys):
    """``launch.paper_eval`` (what ``chip_smoke.py``'s ``paper_fig4`` runs
    on the card): the three arms start from the same parameters, drawn on
    the CPU, and the claims are taken over them."""
    out, verdicts = paper_eval.main(["--device", "cpu", "--steps", "2",
                                     "--seeds", "0"])
    arms = out[0]
    assert set(arms) == set(paper_eval.ARMS)
    assert set(verdicts[0]) == {"dps_matches_baseline(<1.5% gap)",
                                "fixed13_degrades", "dps_avg_bits_below_24"}
    # one initialization: the three arms' first losses agree to the
    # quantization of the first forward
    first = [arms[a]["first_losses"][0] for a in paper_eval.ARMS]
    assert max(first) - min(first) < 0.05 * abs(first[0])
    assert arms["fixed13"]["avg_bits_w"] == 13.0
    assert len(capsys.readouterr().out.strip().splitlines()) == 4
