"""LeNet (Caffe variant) — the paper's evaluation network.

Counterpart of ``repro/models/lenet.py``: conv(5×5, 20) → maxpool2 →
conv(5×5, 50) → maxpool2 → fc(500) + ReLU → fc(10).  Activations are tapped
(quantize + stats) after every layer; the last-layer logit gradient is
quantized analytically in the loss for its statistics (Alg. 1's "Calculate
E and R for last layer Gradients").

Layouts: images arrive NHWC as in the reference and are permuted to NCHW
for ``F.conv2d``; conv weights are OIHW (the reference keeps HWIO;
:func:`repro_torch.convert.lenet_params_from_jax` transposes).  The
flattened conv features are taken in the reference's (h, w, c) order, so
``fc1_w`` is the same matrix in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.fixed_point import QuantStats, fold_seed
from repro_torch.models.common import ParamDef, init_params


CONV_KEYS = ("conv1_w", "conv2_w")


def model_defs() -> Dict[str, Any]:
    return {
        "conv1_w": ParamDef((20, 1, 5, 5), (None,) * 4, scale=1.0),
        "conv1_b": ParamDef((20,), (None,), init="zeros"),
        "conv2_w": ParamDef((50, 20, 5, 5), (None,) * 4, scale=1.0),
        "conv2_b": ParamDef((50,), (None,), init="zeros"),
        "fc1_w": ParamDef((4 * 4 * 50, 500), ("fsdp", "tp")),
        "fc1_b": ParamDef((500,), (None,), init="zeros"),
        "fc2_w": ParamDef((500, 10), (None, None)),
        "fc2_b": ParamDef((10,), (None,), init="zeros"),
    }


def _conv_pool(x, w, b):
    return F.max_pool2d(F.conv2d(x, w, b), 2)


def forward(params, images: torch.Tensor, qctx=None):
    """images (B, 28, 28, 1) -> (logits (B, 10), act_stats, last_stats).

    ``last_stats`` is the final (logit) tap alone — Alg. 1 line 13."""
    stats, last = None, None

    def tap(x, salt):
        nonlocal stats, last
        if qctx is None:
            return x
        q, s = qctx.tap(x, salt)
        if s is not None:
            stats = s if stats is None else stats.merge(s)
            last = s
        return q

    x = images.permute(0, 3, 1, 2)                        # NHWC -> NCHW
    x = tap(_conv_pool(x, params["conv1_w"], params["conv1_b"]), "c1")
    x = tap(_conv_pool(x, params["conv2_w"], params["conv2_b"]), "c2")
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # (h, w, c) order
    x = tap(torch.relu(x @ params["fc1_w"] + params["fc1_b"]), "f1")
    logits = x @ params["fc2_w"] + params["fc2_b"]
    logits = tap(logits, "f2")
    zero = QuantStats.zero(device=images.device)
    return logits, stats or zero, last or zero


def loss_fn(params, batch, qctx=None):
    logits, act_stats, last_stats = forward(params, batch["images"], qctx)
    labels = batch["labels"].to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    aux = {"act_stats": act_stats, "last_act_stats": last_stats,
           "acc": torch.mean((logits.argmax(-1) == labels).to(torch.float32))}

    # Alg. 1 line 20: E and R of the LAST LAYER gradient.  dL/dlogits has
    # the closed form (softmax - onehot)/B; quantize it for stats only.
    if qctx is not None and qctx.collect_stats:
        with torch.no_grad():
            p = torch.softmax(logits.to(torch.float32), dim=-1)
            dlogits = (p - F.one_hot(labels, 10).to(torch.float32)) \
                / logits.shape[0]
            _, gstats = qctx.quantize(dlogits, qctx.grads_fmt,
                                      seed=fold_seed(qctx.seed, 0xD106))
        aux["dlogits_stats"] = gstats
    return loss, aux


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def init(seed: int, device="cpu"):
    """Parameters drawn as the reference draws them — conv weights in HWIO,
    whose fan-in is the input channel count — then laid out OIHW."""
    defs = model_defs()
    for k in CONV_KEYS:
        o, i, h, w = defs[k].shape
        defs[k] = dataclasses.replace(defs[k], shape=(h, w, i, o))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(defs, device, gen)
    for k in CONV_KEYS:
        params[k] = hwio_to_oihw(params[k])
    return params
