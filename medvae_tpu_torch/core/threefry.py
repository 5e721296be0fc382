"""JAX's default PRNG, threefry2x32, and the draws of `jax.random` that the
JAX package's device-cached feeder makes (the port's own copy, so the card
never needs JAX).

The JAX package draws each epoch's batch order with `jax.random` under the
partitionable threefry mode that jax 0.9 uses (`jax_threefry_partitionable`
on). These functions give the same bits: `prng_key(seed)` is
`jax.random.PRNGKey(seed)`, `fold_in`, `split`, `random_bits` (32-bit),
`uniform` (float32 in [0, 1)) and `permutation(key, n)` are their namesakes.
A key is a pair of Python ints (the two uint32 words); bits are uint32
values held in int64 tensors and masked to 32 bits after every add and
shift, on any device.

`permutation` is `jax.random._shuffle`: ceil(3·ln n / ln(2³²−1)) rounds,
each a stable sort of the rows by fresh 32-bit keys (two rounds at 10,240
rows). XLA's `sort_key_val` is stable too, so rows whose keys tie keep the
same order in both.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]
_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(key: Key, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count pairs (x1, x2) under `key`
    (jax._src.prng._threefry2x32_lowering): five groups of four rounds,
    the key schedule added after each."""
    ks = (key[0] & _M, key[1] & _M, (key[0] ^ key[1] ^ 0x1BD11BDA) & _M)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)`: the seed's high and low 32-bit words."""
    seed = int(seed)
    return (seed >> 32) & _M, seed & _M


def _counts(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit iota 0..n-1 (iota_2x32_shape)."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _M


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`: the hash of the count pair (0, data)."""
    y1, y2 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M], dtype=torch.int64))
    return int(y1), int(y2)


def split(key: Key, num: int = 2) -> list:
    """`jax.random.split(key, num)` in the partitionable mode: key i is the
    hash of the count i, its two words the new key's."""
    y1, y2 = threefry2x32(key, *_counts(num, "cpu"))
    return [(int(a), int(b)) for a, b in zip(y1.tolist(), y2.tolist())]


def random_bits(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32-bit `jax.random.bits(key, shape)`: the two words of the hash of
    each element's flat index, xor'd; uint32 values in an int64 tensor."""
    y1, y2 = threefry2x32(key, *_counts(math.prod(shape), device))
    return (y1 ^ y2).reshape(tuple(shape))


def uniform_mantissa(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """The top 23 bits of `random_bits`: `uniform(key, shape)` is these over
    2²³, so they sort as the floats do."""
    return random_bits(key, shape, device) >> 9


def uniform(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape)`, float32 in [0, 1): the mantissa
    bits under the exponent of 1.0, minus 1."""
    bits = uniform_mantissa(key, shape, device) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def shuffle_rounds(n: int) -> int:
    """The number of sort rounds `jax.random._shuffle` takes for n rows."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """`jax.random.permutation(key, n)`: int64 on `device`."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(shuffle_rounds(n)):
        key, subkey = split(key)
        order = torch.sort(random_bits(subkey, (n,), device), stable=True).indices
        x = x[order]
    return x
