"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside its
plain PyTorch version, plus the wrappers that launch them."""
