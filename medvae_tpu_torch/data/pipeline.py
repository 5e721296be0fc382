"""The data feed and on-device batch preprocessing (counterpart of
medvae_tpu/data/pipeline.py and medvae_tpu/train/step.py:119-139).

`DeviceFeeder` walks a split in the JAX feeder's order, bit for bit: the same
numpy permutation per (seed, epoch), optionally modality-stratified
(`stratified_order`), the ragged tail dropped in training and wrapped around
with a `valid` mask in evaluation. Batches are assembled on the host by the
native gather (native/, numpy where it cannot build), copied into pinned
memory and on to the card with non_blocking copies, two batches ahead of the
step; while core/tracing.py records, each batch's gather is a `feed.gather`
span and its pinning and the queueing of its copies a `feed.pin` span.

`DeviceCachedFeeder` pins the split's uint8 images, labels and modality
indices on the device once and assembles every batch there (`assemble`:
gather, one-hot, channel table, `valid`, wraparound), in the JAX package's
`DeviceCachedFeeder` order for the same seed, bit for bit: the epoch's
permutation is drawn from `fold_in(PRNGKey(seed), epoch)` by core/threefry.py
(`jax.random.permutation`, or the stratified order's within-modality
shuffles from `uniform` and a stable argsort). `assemble` takes the step as
a 0-d device tensor, so a captured train step (train/multistep.py) builds
its own batch.

Over a mesh (`mesh=`, core/mesh.py) every rank draws the same order and
takes only its own rows of each global batch (`Mesh.local_rows`, JAX's
per-process slice, medvae_tpu/data/pipeline.py:150-170), so the ranks'
rows concatenated in batch-rank order are the global batch bit for bit; the
global batch must divide by the batch extent. `DeviceCachedFeeder` works
across the ranks of one node (each caches the split on its device) and
raises across nodes, as JAX's does for more than one process.

uint8 → float [0, 1] in the compute dtype → (augment) → Normalize(0.5, 0.5) to
[−1, 1]. The augmentation is the JAX package's: horizontal flip p = 0.5,
rotation by U(−10°, 10°) with bilinear sampling and zeros outside, brightness
and contrast factors U(0.9, 1.1), all batched on the device. Its random draws
come from an explicit torch.Generator, or are passed in (`draws`), so that a
test can hand both packages the same ones. The dtypes follow the JAX code op
for op: the rotation's sampling weights are fp32, so an augmented batch leaves
in fp32, as it does there.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from medvae_tpu_torch import native
from medvae_tpu_torch.core import threefry, tracing
from medvae_tpu_torch.data.medmnist import CHANNELS_BY_MODALITY_INDEX, SplitArrays
from medvae_tpu_torch.data.modalities import MODALITY_NAMES

PREFETCH = 2  # batches in flight ahead of the step, as the JAX feeder keeps

def stratified_order(modality_idx: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """A permutation of [0, n) whose every contiguous window holds a
    near-proportional share of each modality (medvae_tpu/data/pipeline.py:33-65):
    shuffle within each modality, place member r of a c-member modality at
    (r + u) / c with a per-epoch random phase u, and sort by position. Every
    window of B samples then holds B·c_m/n ± 1 samples of modality m, so the
    batch-global separation and contrastive losses see every modality."""
    members_all = []
    pos_all = []
    for m in np.unique(modality_idx):
        members = np.flatnonzero(modality_idx == m)
        rng.shuffle(members)
        c = len(members)
        members_all.append(members)
        pos_all.append((np.arange(c) + rng.uniform()) / c)
    idx = np.concatenate(members_all)
    pos = np.concatenate(pos_all)
    return idx[np.argsort(pos, kind="stable")]


class DeviceFeeder:
    """Iterates the batches of a split on `device`.

    * drops the ragged tail when `drop_last` (training), else pads it by
      wraparound with `valid` 0 on the padding (evaluation), so metrics stay
      exact;
    * shuffles with numpy's RandomState seeded by the epoch, as the JAX
      feeder does, so a (seed, epoch) gives the same batches in both
      packages, and a resumed run can skip the batches it already took;
    * `stratify` (with `shuffle`) draws modality-stratified orders;
    * on a CUDA device each batch goes through pinned host memory with a
      non_blocking copy, PREFETCH batches ahead.
    """

    def __init__(
        self,
        arrays: SplitArrays,
        batch_size: int,
        device,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        stratify: bool = False,
        mesh=None,
    ):
        self.arrays = arrays
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.stratify = bool(stratify) and shuffle
        self._rng = np.random.RandomState(seed)
        # this rank's rows of every global batch (all of them on one rank)
        self._rows = slice(0, batch_size) if mesh is None else mesh.local_rows(batch_size)
        n = len(arrays)
        if drop_last:
            self.steps_per_epoch = max(1, n // batch_size) if n >= batch_size else 1
        else:
            self.steps_per_epoch = (n + batch_size - 1) // batch_size

    def _gather(self, idx: np.ndarray, valid: np.ndarray) -> Dict[str, np.ndarray]:
        a = self.arrays
        batch = native.assemble_batch(a.images, a.labels, a.modality_idx, idx,
                                      CHANNELS_BY_MODALITY_INDEX, len(MODALITY_NAMES))
        if batch is None:  # no native library here: numpy, the same bytes
            onehot = np.zeros((len(idx), len(MODALITY_NAMES)), np.float32)
            onehot[np.arange(len(idx)), a.modality_idx[idx]] = 1.0
            batch = {
                "image_u8": a.images[idx],
                "label": a.labels[idx],
                "modality_onehot": onehot,
                "modality_idx": a.modality_idx[idx],
                # natural channel count per sample, for on-device masking
                "channels": CHANNELS_BY_MODALITY_INDEX[a.modality_idx[idx]],
            }
        batch["valid"] = valid.astype(np.float32)
        return batch

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        n = len(self.arrays)
        order = np.arange(n)
        if self.shuffle:
            self._rng.seed((epoch + 1) * 9973 + 7)
            if self.stratify:
                order = stratified_order(self.arrays.modality_idx, self._rng)
            else:
                self._rng.shuffle(order)
        bs = self.batch_size
        pending: deque = deque()
        for step in range(self.steps_per_epoch):
            idx = order[step * bs: min(step * bs + bs, n)]
            valid = np.ones(len(idx), bool)
            if len(idx) < bs:
                # wraparound pad, masked invalid; modulo tiling so a shortfall
                # larger than the split still fills the batch
                pad = order[np.arange(bs - len(idx)) % n]
                valid = np.concatenate([valid, np.zeros(len(pad), bool)])
                idx = np.concatenate([idx, pad])
            with tracing.span("feed.gather"):
                batch = self._gather(idx[self._rows], valid[self._rows])
            with tracing.span("feed.pin"):
                pending.append(self._put(batch))
            if len(pending) > PREFETCH:
                yield pending.popleft()
        while pending:
            yield pending.popleft()


class DeviceCachedFeeder:
    """A split pinned on `device`, every batch assembled there
    (medvae_tpu/data/pipeline.py:192-372; module docstring). The batches
    and the `steps_per_epoch` are `DeviceFeeder`'s; only the order differs,
    and it is the JAX package's device-cached order for the same seed."""

    def __init__(
        self,
        arrays: SplitArrays,
        batch_size: int,
        device,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        stratify: bool = False,
        mesh=None,
    ):
        if mesh is not None and mesh.dcn > 1:
            raise ValueError("DeviceCachedFeeder serves the ranks of one node; use DeviceFeeder across "
                             "nodes (each rank feeds its own rows)")
        self.arrays = arrays
        self.batch_size = int(batch_size)
        rows = slice(0, self.batch_size) if mesh is None else mesh.local_rows(self.batch_size)
        self._row0, self._local = rows.start, rows.stop - rows.start
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.stratify = bool(stratify) and shuffle
        n = self._n = len(arrays)
        if drop_last:
            self.steps_per_epoch = max(1, n // batch_size) if n >= batch_size else 1
        else:
            self.steps_per_epoch = (n + batch_size - 1) // batch_size
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.images, self.labels, self.midx = put(arrays.images), put(arrays.labels), put(arrays.modality_idx)
        self._ch_table = put(CHANNELS_BY_MODALITY_INDEX)
        self._key = threefry.prng_key(seed)
        if self.stratify:
            self._strat = self._stratified_plan(np.asarray(arrays.modality_idx))

    def _stratified_plan(self, midx: np.ndarray) -> tuple:
        """The static slot → (modality, rank) interleave of the JAX feeder
        (phase 0.5: equal-count modalities tie into an exact round-robin),
        the (modality, max count) member table and its valid mask."""
        present = np.unique(midx)
        counts = np.array([np.sum(midx == m) for m in present])
        maxc = int(counts.max())
        members = np.zeros((len(present), maxc), np.int64)
        pos, mod, rank = [], [], []
        for g, (m, c) in enumerate(zip(present, counts)):
            members[g, :c] = np.flatnonzero(midx == m)
            pos.append((np.arange(c) + 0.5) / c)
            mod.append(np.full(c, g))
            rank.append(np.arange(c))
        slots = np.argsort(np.concatenate(pos), kind="stable")
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)  # noqa: E731
        valid = torch.from_numpy(np.arange(maxc)[None, :] < counts[:, None]).to(self.device)
        return (as_t(members), valid, as_t(np.concatenate(mod)[slots]),
                as_t(np.concatenate(rank)[slots]))

    def __len__(self) -> int:
        return self._n

    @property
    def cache_nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.images, self.labels, self.midx))

    def epoch_perm(self, epoch: int) -> torch.Tensor:
        """The epoch's permutation of [0, n), int64 on the device (a
        placeholder without shuffle, which `assemble` ignores)."""
        if not self.shuffle:
            return torch.zeros((1,), dtype=torch.int64, device=self.device)
        key = threefry.fold_in(self._key, epoch)
        if not self.stratify:
            return threefry.permutation(key, self._n, self.device)
        members, valid, slot_mod, slot_rank = self._strat
        # uniform's floats sort as their mantissa bits; invalid slots last
        u = threefry.uniform_mantissa(key, tuple(members.shape), self.device)
        u = torch.where(valid, u, torch.full_like(u, 1 << 23))
        within = torch.sort(u, dim=1, stable=True).indices
        shuffled = torch.gather(members, 1, within)
        return shuffled[slot_mod, slot_rank]

    def assemble(self, perm: torch.Tensor, step: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's rows of batch `step` (a 0-d int64 tensor on the
        device) of the order `perm`: rows past the split wrap around with
        `valid` 0 (medvae_tpu/data/pipeline.py:283-300)."""
        pos = step * self.batch_size + self._row0 + torch.arange(self._local, device=self.device)
        valid = (pos < self._n).to(torch.float32)
        idx = pos % self._n
        if self.shuffle:
            idx = perm[idx]
        mi = self.midx[idx]
        return {
            "image_u8": self.images[idx],
            "label": self.labels[idx],
            "modality_onehot": torch.nn.functional.one_hot(mi.long(), len(MODALITY_NAMES)).to(torch.float32),
            "modality_idx": mi,
            "channels": self._ch_table[mi.long()],
            "valid": valid,
        }

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        perm = self.epoch_perm(epoch)
        for step in range(self.steps_per_epoch):
            yield self.assemble(perm, torch.tensor(step, dtype=torch.int64, device=self.device))


def split_cache_nbytes(arrays: SplitArrays) -> int:
    """What `DeviceCachedFeeder` pins for `arrays`, in bytes, from the host
    arrays."""
    return int(arrays.images.nbytes + arrays.labels.nbytes + arrays.modality_idx.nbytes)


def augment_draws(
    batch_size: int, generator: Optional[torch.Generator], device
) -> Dict[str, torch.Tensor]:
    """The four per-sample draws of one augmentation, fp32 on `device`:
    flip (bool), angle in degrees, brightness and contrast factors."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand((batch_size,), generator=generator, device=device)
        return lo + (hi - lo) * u

    return {
        "flip": torch.rand((batch_size,), generator=generator, device=device) < 0.5,
        "angle": uniform(-10.0, 10.0),
        "brightness": uniform(0.9, 1.1),
        "contrast": uniform(0.9, 1.1),
    }


def rotate_batch(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each NHWC image by its own angle (radians) with bilinear
    sampling, zeros outside (JAX `_rotate_batch`)."""
    b, h, w, _ = x.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=x.dtype, device=x.device),
        torch.arange(w, dtype=x.dtype, device=x.device),
        indexing="ij",
    )
    yc, xc = yy - (h - 1) / 2.0, xx - (w - 1) / 2.0
    cos = torch.cos(angles)[:, None, None]
    sin = torch.sin(angles)[:, None, None]
    src_y = cos * yc - sin * xc + (h - 1) / 2.0  # (b, h, w) fp32
    src_x = sin * yc + cos * xc + (w - 1) / 2.0
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = src_y - y0
    wx = src_x - x0
    bidx = torch.arange(b, device=x.device)[:, None, None]

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yi_c = yi.clamp(0, h - 1).long()
        xi_c = xi.clamp(0, w - 1).long()
        return x[bidx, yi_c, xi_c] * inside[..., None].to(x.dtype)

    return (
        gather(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
        + gather(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
        + gather(y0 + 1, x0) * (wy * (1 - wx))[..., None]
        + gather(y0 + 1, x0 + 1) * (wy * wx)[..., None]
    )


def normalize_and_augment(
    image_u8: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    augment: bool = False,
    dtype: torch.dtype = torch.float32,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """uint8 NHWC → float in [0, 1], augmented when `augment` (with `draws`,
    or draws from `generator`), then mapped to [−1, 1] unless `normalize` is
    False (medvae_tpu/data/pipeline.py:381-417)."""
    x = image_u8.to(dtype) / torch.tensor(255.0, dtype=dtype)
    if augment:
        if draws is None:
            draws = augment_draws(x.shape[0], generator, x.device)
        flip = draws["flip"].to(x.device)[:, None, None, None]
        x = torch.where(flip, x.flip(2), x)
        angles = draws["angle"].to(device=x.device, dtype=torch.float32)
        x = rotate_batch(x, angles * math.pi / 180.0)
        bri = draws["brightness"].to(device=x.device, dtype=torch.float32)[:, None, None, None]
        con = draws["contrast"].to(device=x.device, dtype=torch.float32)[:, None, None, None]
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = torch.clamp((x * bri - mean) * con + mean, 0.0, 1.0)
    return x * 2.0 - 1.0 if normalize else x


def preprocess(
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    augment: bool,
    max_channels: int,
    dtype: torch.dtype = torch.float32,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """The train step's input: normalized (and augmented) images with the
    channels a modality lacks zeroed again after normalization."""
    x = normalize_and_augment(
        batch["image_u8"], generator, augment=augment, dtype=dtype, draws=draws, normalize=normalize
    )
    if "channels" in batch and max_channels > 1:
        arange = torch.arange(max_channels, device=x.device)
        mask = (arange[None, :] < batch["channels"].to(x.device)[:, None]).to(x.dtype)
        x = x * mask[:, None, None, :]
    return x
