"""The placed MoE layer where the all-to-all gate fails (decode's S = 1, a
sequence the model axis does not divide): the einsum dispatch split over
the mesh as the reference's compiled step splits it, each rank its rows
and its experts, with the capacity slots taken in the global token order
against the global capacity.  Every case here drops choices, so slots
taken per rank would show.

* The layer at decode (B, 1, D), smoke qwen3-moe and deepseek-v2 (one
  shared expert) at ``capacity_factor`` ``DROP_CF``, on stacked (1, 4) and
  (2, 4) meshes: the output and the gradients of every input and
  parameter against the plain einsum dispatch on the whole batch.
* Placed decode of both models at (2, 4), batch ``SERVE_B``, against the
  reference's decode jitted under ``decode_shardings`` (job
  ``sharded_serve``), with the same ``DROP_CF``.
* A qwen3-moe train step at sequence ``TRAIN_SEQ`` (not a multiple of
  the model axis, so every MoE layer takes the einsum) on a stacked
  (2, 4) mesh against the reference's sharded step (job
  ``sharded_step``): formats equal, loss to ``LOSS_RTOL``, parameters
  within ``PARAM_DIFF_STEPS`` weight-grid steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.dist.sharding import StackedMesh
from repro_torch.models import moe
from repro_torch.models.common import init_params
from test_torch_jaxref import run_reference, unflatten
from test_torch_tp import (_cfg, _check_against, _close_params, _ref_params,
                           _run)
from test_torch_tp_families import RESIDUAL, _layer_check, _x
from test_torch_tp_serve import MAX_SEQ, STEPS, _hold, _ref_out, _serve

ARCHS = {"qwen3_moe": "qwen3_moe_30b_a3b", "deepseek_v2": "deepseek_v2_236b"}
MESHES = [(1, 4), (2, 4)]
# capacity 8 (its floor) at the decode batches below: on average 1× and
# 2× as many choices an expert as slots
DROP_CF = 0.25
LAYER_B = 32
SERVE_B, PROMPT = 64, 12
TRAIN_SEQ = 14
TRAIN_CF = 0.5


def _drop_cfg(tag):
    return dataclasses.replace(smoke(get_config(ARCHS[tag])),
                               capacity_factor=DROP_CF)


def _serve_inputs(tag):
    cfg = _drop_cfg(tag)
    g = np.random.default_rng(29)
    return {"tokens": g.integers(0, cfg.vocab,
                                 (SERVE_B, PROMPT)).astype(np.int32),
            "steps": g.integers(0, cfg.vocab,
                                (SERVE_B, STEPS)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref():
    jobs, arrays = [], {}
    for tag, arch in ARCHS.items():
        jobs.append({"job": "sharded_serve", "tag": tag,
                     "kw": {"arch": arch, "max_seq": MAX_SEQ, "mesh": [2, 4],
                            "overrides": {"capacity_factor": DROP_CF},
                            "whole": False}})
        arrays.update({f"{tag}/{k}": v for k, v in _serve_inputs(tag).items()})
    jobs.append({"job": "sharded_step", "tag": "train",
                 "kw": {"steps": 3, "seq": TRAIN_SEQ, "batch": 8,
                        "mesh": [2, 4], "arch": ARCHS["qwen3_moe"],
                        "overrides": {"capacity_factor": TRAIN_CF},
                        "whole": False}})
    return run_reference(jobs, arrays, host_devices=8)


def _dropped(cfg, p, x, data):
    """Choices the global order drops, and whether slots taken per data
    rank (each rank's rows against the same capacity) would keep another
    set."""
    x2 = x.reshape(-1, x.shape[-1])
    _, top_i, _ = moe._router(cfg, p["router"], x2)
    C = moe._capacity(x2.shape[0], cfg)
    keep = moe._slots(cfg, top_i, C)[1]
    per_rank = torch.cat([moe._slots(cfg, t, C)[1]
                          for t in top_i.chunk(data)])
    return int((~keep).sum()), not torch.equal(keep, per_rank)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", ARCHS)
def test_placed_moe_decode_with_drops_matches_the_einsum(tag, shape):
    cfg = _drop_cfg(tag)
    x = _x((LAYER_B, 1, cfg.d_model))
    defs = moe.moe_defs(cfg, torch.float32)
    # _layer_check's draw of the parameters
    p = init_params(defs, "cpu", torch.Generator().manual_seed(1))
    dropped, per_rank_differs = _dropped(cfg, p, x, shape[0])
    assert dropped > 0
    assert per_rank_differs == (shape[0] > 1)
    calls = dict(moe.DISPATCH_COUNTS)
    # the output laid out over (data, model), each element on one rank
    _layer_check(defs, lambda p, x: moe.moe_apply(cfg, p, x)[0], [x],
                 [RESIDUAL], ("batch", None, "tp"),
                 StackedMesh(shape, ("data", "model")),
                 split=[("w_in",), ("w_gate",), ("w_out",)], seed=1)
    # the whole run and the placed one, both on the einsum
    assert moe.DISPATCH_COUNTS["einsum"] - calls["einsum"] == 2
    assert moe.DISPATCH_COUNTS["a2a"] == calls["a2a"]


@pytest.mark.parametrize("tag", ARCHS)
def test_placed_decode_with_drops_matches_reference_sharded_decode(
        ref, monkeypatch, tag):
    """The decode steps' MoE layers drop choices (the capacity slots of
    every einsum dispatch at T = ``SERVE_B`` recorded); the logits, greedy
    tokens and caches held as ``test_torch_tp_serve`` holds them."""
    cfg = _drop_cfg(tag)
    slots, kept = moe._slots, []

    def record(cfg_, top_i, C):
        pos, keep = slots(cfg_, top_i, C)
        if top_i.shape[0] == SERVE_B:
            kept.append(keep)
        return pos, keep

    monkeypatch.setattr(moe, "_slots", record)
    params = params_from_jax(unflatten(ref, f"{tag}/params/"), cfg, "cpu")
    got = _serve(cfg, params, _serve_inputs(tag),
                 StackedMesh((2, 4), ("data", "model")))
    # every rank's copy of every MoE layer's slots, each decode step
    assert kept and len(kept) % (STEPS * 8) == 0
    assert all(not bool(k.all()) for k in kept)
    _hold(cfg, got, _ref_out(ref, tag, "sharded"))


def test_placed_moe_train_step_on_the_einsum_matches_reference(ref):
    """``TRAIN_SEQ`` % 4 != 0: every MoE layer of the placed step takes
    the split einsum dispatch, forward and backward, at ``TRAIN_CF``
    (choices dropped)."""
    cfg = dataclasses.replace(_cfg("qwen3_moe_30b_a3b"),
                              capacity_factor=TRAIN_CF)
    calls = dict(moe.DISPATCH_COUNTS)
    hist, final = _run(cfg, StackedMesh((2, 4), ("data", "model")),
                       _ref_params(ref, cfg, "train/params/"), seq=TRAIN_SEQ)
    assert moe.DISPATCH_COUNTS["a2a"] == calls["a2a"]
    assert moe.DISPATCH_COUNTS["einsum"] > calls["einsum"]
    want = {k: list(ref[f"train/sharded/hist/{k}"]) for k in hist}
    _check_against(hist, want)
    _close_params(final, _ref_params(ref, cfg, "train/sharded/final/"),
                  hist["fl_w"][-1])
