"""Seeds and per-step random streams (counterpart of medvae_tpu/core/rng.py).

The JAX package folds the optimizer step into one root key, so a step's draws
depend only on (seed, step) and a resumed run draws what the uninterrupted
one did. The port keeps that: `fold_in` mixes integers into a 63-bit seed
(splitmix64), and the trainer re-seeds its torch.Generator with
`fold_in(seed, stream, step)` before every step. Torch and JAX give different
numbers from the same seed; only the structure is shared.
"""

from __future__ import annotations

import random

import numpy as np
import torch

_MASK = (1 << 64) - 1


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def fold_in(seed: int, *data: int) -> int:
    """A seed for torch.Generator.manual_seed from `seed` and `data`, in
    order (splitmix64 over each word)."""
    h = int(seed) & _MASK
    for d in data:
        h = (h ^ (int(d) & _MASK)) + 0x9E3779B97F4A7C15 & _MASK
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK
        h ^= h >> 31
    return h >> 1
