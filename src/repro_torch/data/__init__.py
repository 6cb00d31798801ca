"""Synthetic data (numpy copies of ``repro.data``; no network)."""

from repro_torch.data.mnist import MNISTLike, make_split
from repro_torch.data.synthetic import TokenStream, TokenStreamConfig
