"""Optimizers (counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import (AdamW, AdamWConfig, SGD, SGDConfig,
                                          make_optimizer)
