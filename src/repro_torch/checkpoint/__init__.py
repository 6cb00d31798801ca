"""repro_torch.checkpoint — atomic, digest-verified checkpoints in the
reference's on-disk format (counterpart of ``repro/checkpoint``)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    AsyncCheckpointer, flatten_tree, latest_step, load_flat, prune, restore,
    rng_of_seed, save, seed_of_rng, verify_step)
