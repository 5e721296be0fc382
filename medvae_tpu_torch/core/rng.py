"""Seeds and per-step random streams (counterpart of medvae_tpu/core/rng.py).

The JAX package folds the optimizer step into one root key, so a step's draws
depend only on (seed, step) and a resumed run draws what the uninterrupted
one did. The port keeps that: `fold_in` mixes integers into a 63-bit seed
(splitmix64), and the trainer re-seeds its torch.Generator with
`fold_in(seed, stream, step)` before every step. Torch and JAX give different
numbers from the same seed; only the structure is shared.

`RngStream` is the JAX package's named stream over JAX keys themselves
(core/threefry.py): its keys are JAX's words bit for bit.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from medvae_tpu_torch.core import threefry

_MASK = (1 << 64) - 1


def set_seed(seed: int) -> threefry.Key:
    """Seed Python's, numpy's and torch's global generators; returns the
    root key, `jax.random.PRNGKey(seed)`'s words, as the JAX package does."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return threefry.prng_key(seed)


class RngStream:
    """A named, counted stream of JAX keys: `stream(step)` is a unique key a
    step, `split(n)` n keys (medvae_tpu/core/rng.py:26-37)."""

    def __init__(self, root: threefry.Key, name: str):
        self._key = threefry.fold_in(root, _stable_hash(name))
        self.name = name

    def __call__(self, step: int) -> threefry.Key:
        return threefry.fold_in(self._key, step)

    def split(self, n: int) -> list:
        return threefry.split(self._key, n)


def _stable_hash(s: str) -> int:
    """FNV-1a over the name's bytes (medvae_tpu/core/rng.py:40-44)."""
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h


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
