"""The port's device-cached feeder and its PRNG against the JAX package's,
on the CPU, bitwise.

`core/threefry.py` against `jax.random` (PRNGKey, fold_in, split, 32-bit
bits, uniform, permutation) over seeds and shapes; `DeviceCachedFeeder`
against JAX's, plain and stratified, with and without drop_last, every batch
of three epochs; the native gather against numpy and against the JAX
package's native gather; `split_cache_nbytes` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu import native as jnative
from medvae_tpu.data import medmnist as jmed
from medvae_tpu.data import pipeline as jpipe
from medvae_tpu_torch import native as tnative
from medvae_tpu_torch.core import threefry
from medvae_tpu_torch.data import medmnist as tmed
from medvae_tpu_torch.data import pipeline as tpipe

SEEDS = (0, 42, 7, 2**31 - 1)


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_are_jax_random_keys(seed):
    key, tkey = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert _words(key) == tkey
    for data in (0, 1, 9, 2**32 - 1):
        assert _words(jax.random.fold_in(key, data)) == threefry.fold_in(tkey, data)
    for num in (2, 3):
        assert [_words(k) for k in jax.random.split(key, num)] == threefry.split(tkey, num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (5, 2048)])
def test_bits_and_uniform_are_jax_randoms(seed, shape):
    key, tkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3), threefry.fold_in(threefry.prng_key(seed), 3)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(threefry.random_bits(tkey, shape).numpy(), bits)
    u = np.asarray(jax.random.uniform(key, shape))
    assert np.array_equal(threefry.uniform(tkey, shape).numpy().view(np.int32), u.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 100, 10240])
def test_permutation_is_jax_random_permutation(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    tkey = threefry.fold_in(threefry.prng_key(seed), 1)
    assert np.array_equal(threefry.permutation(tkey, n).numpy(), np.asarray(jax.random.permutation(key, n)))


def test_shuffle_rounds_tie_free_and_tied_keys_keep_jax_order():
    """Two rounds at 10,240 rows, three past 2^21; where two rows draw the
    same 32-bit key both stable sorts keep them in row order: a key made to
    tie everywhere (a sort that permutes nothing) stays the identity."""
    assert threefry.shuffle_rounds(10240) == 2 and threefry.shuffle_rounds(3 * 2**20) == 3
    keys = np.zeros(64, np.uint32)
    _, vals = jax.lax.sort_key_val(jnp.asarray(keys), jnp.arange(64))
    assert np.array_equal(np.asarray(vals), torch.sort(torch.zeros(64, dtype=torch.int64), stable=True).indices.numpy())


def _mixed_split(n=700, size=8):
    """Five modalities of unequal counts (stratification's phases tie only
    where counts are equal), uint8 images that name their row."""
    rs = np.random.RandomState(5)
    midx = np.sort(rs.choice([0, 1, 3, 6, 9], size=n, p=[0.4, 0.2, 0.2, 0.1, 0.1])).astype(np.int32)
    images = rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    return jmed.SplitArrays(images=images, labels=rs.randint(0, 9, n).astype(np.int32),
                            modality_idx=midx, channels=3)


@pytest.mark.parametrize("shuffle, stratify, drop_last", [
    (True, False, True), (True, True, True), (True, False, False), (True, True, False),
    (False, False, False), (False, False, True),
])
def test_cached_feeder_batches_are_the_jax_cached_feeders(shuffle, stratify, drop_last):
    arrays = _mixed_split()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = jpipe.DeviceCachedFeeder(arrays, 96, mesh, shuffle=shuffle, drop_last=drop_last, seed=11,
                                   stratify=stratify)
    port = tpipe.DeviceCachedFeeder(tmed.SplitArrays(**vars(arrays)), 96, "cpu", shuffle=shuffle,
                                    drop_last=drop_last, seed=11, stratify=stratify)
    assert port.steps_per_epoch == ref.steps_per_epoch and len(port) == len(ref)
    for epoch in range(3):
        if shuffle:
            assert np.array_equal(port.epoch_perm(epoch).numpy(), np.asarray(ref.epoch_perm(epoch)))
        want, got = list(ref.epoch(epoch)), list(port.epoch(epoch))
        assert len(got) == len(want) == ref.steps_per_epoch
        for b_got, b_want in zip(got, want):
            assert set(b_got) == set(b_want)
            for k in b_want:
                assert b_got[k].numpy().dtype == np.asarray(b_want[k]).dtype, k
                assert np.array_equal(b_got[k].numpy(), np.asarray(b_want[k])), (epoch, k)
    if not drop_last:
        assert got[-1]["valid"].sum().item() == 700 - 7 * 96


def test_stratified_order_covers_every_modality_in_every_batch():
    port = tpipe.DeviceCachedFeeder(tmed.SplitArrays(**vars(_mixed_split())), 32, "cpu", seed=2,
                                    stratify=True)
    perm = port.epoch_perm(0)
    assert sorted(perm.tolist()) == list(range(700))
    for batch in port.epoch(0):
        assert len(set(batch["modality_idx"].tolist())) == 5


def test_split_cache_nbytes_is_jax_s():
    arrays = _mixed_split()
    assert tpipe.split_cache_nbytes(tmed.SplitArrays(**vars(arrays))) == jpipe.split_cache_nbytes(arrays)
    port = tpipe.DeviceCachedFeeder(tmed.SplitArrays(**vars(arrays)), 32, "cpu")
    assert port.cache_nbytes == jpipe.split_cache_nbytes(arrays)


def test_native_gather_is_numpy_s_and_jax_s():
    if not tnative.available():
        pytest.skip("no host C++ compiler here")
    arrays = _mixed_split()
    idx = np.random.RandomState(0).randint(0, 700, 257)
    args = (arrays.images, arrays.labels, arrays.modality_idx, idx, tmed.CHANNELS_BY_MODALITY_INDEX,
            len(tmed.MODALITY_NAMES))
    before = tnative.calls
    got = tnative.assemble_batch(*args)
    assert tnative.calls == before + 1
    want = jnative.assemble_batch(*args)
    assert want is not None and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["image_u8"], arrays.images[idx])
    assert np.array_equal(got["label"], arrays.labels[idx])
    onehot = np.zeros((257, len(tmed.MODALITY_NAMES)), np.float32)
    onehot[np.arange(257), arrays.modality_idx[idx]] = 1.0
    assert np.array_equal(got["modality_onehot"], onehot)
    assert np.array_equal(got["channels"], tmed.CHANNELS_BY_MODALITY_INDEX[arrays.modality_idx[idx]])


def test_host_feeder_takes_the_native_gather():
    if not tnative.available():
        pytest.skip("no host C++ compiler here")
    feeder = tpipe.DeviceFeeder(tmed.SplitArrays(**vars(_mixed_split())), 64, "cpu", seed=1)
    before = tnative.calls
    assert len(list(feeder.epoch(0))) == feeder.steps_per_epoch
    assert tnative.calls == before + feeder.steps_per_epoch
