"""Paper-faithful LeNet/MNIST-class DPS training (counterpart of
``repro/apps/mnist.py``).

Hyper-parameters follow the paper: batch 64, SGD momentum 0.9, lr 0.01 with
inverse decay (γ=1e-4, pow=0.75), weight decay 5e-4, E_max = R_max = 0.01%,
precision updated once per iteration, stats taken on the last layer's
activations/gradients (``stat_scope="last_layer"``).

Runs on CUDA unless ``device="cpu"`` is asked for.  Convolutions and
matrix products run in full float32 (TF32 off while it trains), as the
reference's do.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import qtrain
from repro_torch.core.dps import DPSHyper
from repro_torch.data import MNISTLike
from repro_torch.device import resolve_device
from repro_torch.models import lenet
from repro_torch.optim import SGDConfig, make_optimizer


def paper_quant_config(controller: str = "paper",
                       rounding: str = "stochastic",
                       il_init: int = 8, fl_init: int = 12,
                       static_bits: Optional[int] = None,
                       static_scope: str = "all",
                       na_window: int = 30) -> qtrain.QuantConfig:
    """Quantization config for the paper's evaluation.

    ``static_bits`` gives the fixed-width ablations (the paper's naive
    13-bit run, Gupta's 16-bit runs) under the ``"static"`` controller:
    weights ⟨2, n-2⟩ (resolution), activations ⟨8, n-8⟩ and gradients
    ⟨6, n-6⟩ (range), every attribute at the static width.  With
    ``static_scope="weights"`` only the weights are narrowed (Gupta-style:
    stochastic rounding keeps sub-half-grid weight updates in
    expectation), activations at ⟨8, 8⟩ and gradients at ⟨6, 18⟩.  The
    formats are those of the reference's code; its docstring says
    activations ⟨6, n-6⟩, which its code does not use.

    Without ``static_bits``: the adaptive ``controller`` from
    ⟨il_init, fl_init⟩ (gradients from FL 16), with ``na_window`` passed to
    every domain's hyper-parameters."""
    if static_bits is not None:
        hw = DPSHyper(il_init=2, fl_init=static_bits - 2)
        if static_scope == "weights":
            ha = DPSHyper(il_init=8, fl_init=8)
            hg = DPSHyper(il_init=6, fl_init=18)
        else:
            ha = DPSHyper(il_init=8, fl_init=static_bits - 8)
            hg = DPSHyper(il_init=6, fl_init=static_bits - 6)
        return qtrain.QuantConfig(
            enabled=True, controller="static", rounding=rounding,
            hyper_weights=hw, hyper_acts=ha, hyper_grads=hg,
            stat_scope="last_layer")
    kw = dict(r_max=1e-4, e_max=1e-4, na_window=na_window)
    h = DPSHyper(il_init=il_init, fl_init=fl_init, **kw)
    hg = DPSHyper(il_init=il_init, fl_init=16, **kw)
    return qtrain.QuantConfig(
        enabled=True, controller=controller, rounding=rounding,
        hyper_weights=h, hyper_acts=h, hyper_grads=hg,
        stat_scope="last_layer")


@contextlib.contextmanager
def _full_fp32(device: torch.device):
    """TF32 off for CUDA matrix products and convolutions while the block
    runs; the flags are process-wide, so they are put back after it."""
    if device.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train_mnist(qcfg: Optional[qtrain.QuantConfig], steps: int = 2000,
                batch: int = 64, seed: int = 0, eval_every: int = 0,
                data: Optional[MNISTLike] = None, device="cuda",
                params=None) -> Dict:
    """Train LeNet; ``qcfg=None`` is the fp32 baseline.  Returns history.

    ``params``: start from these (e.g. the reference's, converted) instead
    of drawing them from ``seed``.
    """
    device = resolve_device(device)
    with _full_fp32(device):
        data = data or MNISTLike(batch=batch, seed=seed)
        if params is None:
            params = lenet.init(seed, device)
        opt = make_optimizer(SGDConfig())            # paper defaults
        if qcfg is None:
            qcfg = qtrain.QuantConfig(enabled=False)
        step_fn = qtrain.make_train_step(lenet.loss_fn, opt, qcfg)
        state = qtrain.TrainState.create(params, opt.init(params), qcfg,
                                         seed + 1, device)

        hist: Dict[str, List] = {k: [] for k in
                                 ("loss", "acc", "il_w", "fl_w", "il_a", "fl_a",
                                  "il_g", "fl_g", "E_a", "R_a", "test_acc")}
        test = data.test_set()
        test_x = torch.from_numpy(test["images"]).to(device)
        test_y = torch.from_numpy(test["labels"]).to(device)

        def test_acc(params):
            with torch.no_grad():
                logits, _, _ = lenet.forward(params, test_x)
                return float(torch.mean((logits.argmax(-1) == test_y)
                                        .to(torch.float32)))

        for i in range(steps):
            b = data.train_batch(i)
            batch_t = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            state, m = step_fn(state, batch_t)
            for k in ("loss", "il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g",
                      "E_a", "R_a"):
                hist[k].append(float(m[k]))
            if eval_every and (i + 1) % eval_every == 0:
                hist["test_acc"].append((i + 1, test_acc(state.params)))

        hist["final_test_acc"] = test_acc(state.params)
        hist["avg_bits_w"] = float(np.mean(np.add(hist["il_w"], hist["fl_w"])))
        hist["avg_bits_a"] = float(np.mean(np.add(hist["il_a"], hist["fl_a"])))
        hist["avg_bits_g"] = float(np.mean(np.add(hist["il_g"], hist["fl_g"])))
        hist["diverged"] = bool(not np.isfinite(hist["loss"][-1])
                                or hist["loss"][-1] > 2.0)
        return hist
