"""SGD and AdamW of the port against the JAX package's.

Three replicated updates from the same numpy parameters and gradients, in
both packages.  Held: the parameters after every update, and the learning
rate of every step, within 1 ulp (float32).  The arithmetic is the same
operation for operation; the port computes the schedule on the host in
float32 (numpy) where the reference computes it on the device, and a
float32 ``pow`` or ``cos`` may round the last bit either way.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.optim import AdamWConfig, SGDConfig, make_optimizer
from repro_torch.optim import optimizers as opt_lib
from test_torch_jaxref import flatten, run_reference, unflatten

STEPS = 3
_rng = np.random.default_rng(5)


def _tree():
    return {"w": _rng.standard_normal((6, 10)).astype(np.float32),
            "blk": {"b": _rng.standard_normal(7).astype(np.float32),
                    "k": _rng.standard_normal((3, 4, 5)).astype(np.float32)}}


PARAMS = _tree()
GRADS = [_tree() for _ in range(STEPS)]
CASES = {
    "sgd": ("sgd", {}),
    "sgd_const_clip": ("sgd", {"schedule": "const", "clip_norm": 0.5,
                               "lr": 0.03, "momentum": 0.8}),
    "adamw": ("adamw", {"warmup": 2, "total_steps": 10}),
    "adamw_noclip": ("adamw", {"clip_norm": 0.0, "warmup": 0,
                               "total_steps": 5, "weight_decay": 0.01}),
}


@pytest.fixture(scope="module")
def ref():
    arrays = {}
    for tag in CASES:
        arrays.update(flatten(PARAMS, f"{tag}/params/"))
        for t, g in enumerate(GRADS):
            arrays.update(flatten(g, f"{tag}/grads{t}/"))
    jobs = [{"job": "optim", "tag": tag,
             "kw": {"kind": kind, "steps": STEPS, "kw": kw}}
            for tag, (kind, kw) in CASES.items()]
    return run_reference(jobs, arrays)


def _cfg(kind, kw):
    return SGDConfig(**kw) if kind == "sgd" else AdamWConfig(**kw)


def _torch_tree(tree):
    return tree_lib.map_tree(lambda a: torch.from_numpy(a.copy()), tree)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_updates_match_reference_within_one_ulp(ref, tag):
    kind, kw = CASES[tag]
    opt = make_optimizer(_cfg(kind, kw))
    params = _torch_tree(PARAMS)
    state = opt.init(params)
    for t in range(STEPS):
        out, st = opt.update(_torch_tree(GRADS[t]), state, params, count=t)
        assert out is params and st is state          # in place
        np.testing.assert_array_max_ulp(np.float32(opt.sched(t)),
                                        ref[f"{tag}/lr{t}"], maxulp=1)
        want = unflatten(ref, f"{tag}/p{t}/")
        for (path, got), (_, w) in zip(tree_lib.leaves_with_path(params),
                                       tree_lib.leaves_with_path(want)):
            np.testing.assert_array_max_ulp(got.numpy(), w, maxulp=1)


def test_bf16_state_is_stochastically_rounded_and_unbiased():
    x = torch.from_numpy(_rng.standard_normal(4096).astype(np.float32))
    acc = torch.zeros(4096, dtype=torch.float64)
    for s in range(64):
        y = opt_lib._sr_cast(x, torch.bfloat16, s)
        assert y.dtype == torch.bfloat16
        acc += y.to(torch.float64)
    # one bf16 step of x is its float32 ulp times 2^16
    step = (np.spacing(np.abs(x.numpy())) * 65536).astype(np.float64)
    sigma = np.sqrt((step ** 2 / 4).sum() / 64)
    assert abs(float((acc / 64 - x.to(torch.float64)).sum())) < 4 * sigma
    assert torch.equal(opt_lib._sr_cast(x, torch.bfloat16, 3),
                       opt_lib._sr_cast(x, torch.bfloat16, 3))
    assert opt_lib._sr_cast(x, torch.float32, 0) is x


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_bf16_state_steps(kind):
    cfg = _cfg(kind, {"state_dtype": "bfloat16"})
    opt = make_optimizer(cfg)
    params = _torch_tree(PARAMS)
    state = opt.init(params)
    assert all(v.dtype == torch.bfloat16 for v in tree_lib.leaves(state))
    before = [p.clone() for p in tree_lib.leaves(params)]
    opt.update(_torch_tree(GRADS[0]), state, params, count=1)  # past lr 0
    after = tree_lib.leaves(params)
    assert all(bool(torch.isfinite(p).all()) for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_schedules_and_clip():
    f = opt_lib.inv_decay(0.01, 1e-4, 0.75)
    assert f(0) == np.float32(0.01) and f(1000) < f(0)
    c = opt_lib.cosine_schedule(1.0, 10, 110)
    assert c(0) == 0.0 and c(5) == np.float32(0.5) and abs(c(110) - 0.1) < 1e-6
    g = {"a": torch.full((4,), 3.0), "b": torch.full((1,), 4.0)}   # norm 7.2
    clipped, n = opt_lib._clip_by_norm(g, 1.0)
    assert abs(float(n) - 52 ** 0.5) < 1e-5
    assert abs(float(opt_lib._global_norm(clipped)) - 1.0) < 1e-6
    with pytest.raises(TypeError):
        make_optimizer(object())
    with pytest.raises(ValueError, match="structure"):
        opt = make_optimizer(SGDConfig())
        p = _torch_tree(PARAMS)
        opt.update({"w": torch.zeros(6, 10)}, opt.init(p), p, count=0)
