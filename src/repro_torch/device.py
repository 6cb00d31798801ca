"""The device rule of the port's entry points: CUDA unless the CPU is asked
for, and never the CPU in place of a CUDA device that is missing."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """An entry point's ``device`` argument as a ``torch.device``; asking for
    CUDA on a machine without it raises rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return device
