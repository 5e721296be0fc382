"""MedMNIST host data (the port's copy of medvae_tpu/data/medmnist.py, which
imports no JAX; the port keeps its own).

  * the 12-dataset modality→index map (data/modalities.py);
  * the per-modality natural channel policy, grayscale X-ray/CT against RGB
    microscopy, with RGB↔gray by the reference luma weights;
  * labels standardized to one int a sample;
  * every split materialized once into fixed-shape uint8 arrays, channels
    converted and zero-padded to the datasets' max, so that batch assembly is
    one fancy index and normalization/augmentation run on the device in the
    train step.

Data sources: the official `<name>.npz` / `<name>_<size>.npz` MedMNIST files if
present under `root`; otherwise a deterministic synthetic generator with
per-modality structure, bit for bit the JAX package's (numpy RandomState).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medvae_tpu_torch.data.modalities import MODALITY_NAMES, modality_index

_GRAYSCALE = {"chestmnist", "pneumoniamnist", "organamnist", "organcmnist", "organsmnist"}
_RGB = {
    "pathmnist",
    "dermamnist",
    "retinamnist",
    "bloodmnist",
    "tissuemnist",
    "octmnist",
    "breastmnist",
}

# Natural channel policy (reference :154-181)
DATASET_CHANNELS: Dict[str, int] = {
    **{n: 1 for n in _GRAYSCALE},
    **{n: 3 for n in _RGB},
}

# channel count per modality index (for on-device channel masking)
CHANNELS_BY_MODALITY_INDEX = np.array(
    [DATASET_CHANNELS[n] for n in MODALITY_NAMES], np.int32
)

# Class counts for the synthetic generator (approximate MedMNIST label spaces)
_N_CLASSES: Dict[str, int] = {
    "chestmnist": 14,
    "pathmnist": 9,
    "octmnist": 4,
    "pneumoniamnist": 2,
    "dermamnist": 7,
    "bloodmnist": 8,
    "tissuemnist": 8,
    "retinamnist": 5,
    "breastmnist": 2,
    "organamnist": 11,
    "organcmnist": 11,
    "organsmnist": 11,
}

_SYNTH_SIZES = {"train": 2048, "val": 256, "test": 256}


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """(..., 3) → (..., 1) with the reference luma weights (:211)."""
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return gray[..., None]


def _standardize_labels(labels: np.ndarray) -> np.ndarray:
    """Reference label policy (:223-242): multi-label → argmax (0 if no positive),
    everything → one int per sample."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        return labels.astype(np.int32)
    if labels.shape[1] == 1:
        return labels[:, 0].astype(np.int32)
    any_pos = labels.sum(axis=1) > 0
    arg = labels.argmax(axis=1)
    return np.where(any_pos, arg, 0).astype(np.int32)


def _resize_nearest(images: np.ndarray, size: int) -> np.ndarray:
    """Host-side resize for uint8 stacks (rare path: the packaged npz already
    matches `size` for the standard 28/64/128/224 sizes). Bilinear via PIL to
    match torchvision Resize; nearest-neighbour fallback without PIL."""
    n, h, w, c = images.shape
    if h == size and w == size:
        return images
    try:
        from PIL import Image

        out = np.empty((n, size, size, c), np.uint8)
        for i in range(n):
            img = images[i, ..., 0] if c == 1 else images[i]
            resized = np.asarray(
                Image.fromarray(img).resize((size, size), Image.BILINEAR)
            )
            out[i] = resized[..., None] if c == 1 else resized
        return out
    except ImportError:
        ys = (np.arange(size) * h // size).clip(0, h - 1)
        xs = (np.arange(size) * w // size).clip(0, w - 1)
        return images[:, ys][:, :, xs]


def _synthetic_split(
    name: str, split: str, size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic structured fake data: per-modality frequency/phase signature
    plus per-class blob position, so reconstruction/PSNR/latent-separation tests
    and benchmarks behave like real images (not white noise)."""
    midx = modality_index(name)
    n = _SYNTH_SIZES.get(split, 256)
    n_classes = _N_CLASSES[name]
    rng = np.random.RandomState(seed * 1000 + midx * 10 + {"train": 0, "val": 1, "test": 2}[split])
    labels = rng.randint(0, n_classes, size=n).astype(np.int32)

    yy, xx = np.meshgrid(
        np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij"
    )
    base_freq = 2.0 + midx * 1.5
    images = np.zeros((n, size, size, 3), np.float32)
    cx = 0.2 + 0.6 * (labels % 4) / 3.0
    cy = 0.2 + 0.6 * (labels // 4 % 4) / 3.0
    phase = rng.rand(n, 1, 1) * 2 * np.pi
    wave = 0.5 + 0.25 * np.sin(
        base_freq * 2 * np.pi * (yy[None] + xx[None]) + phase
    )
    blob = np.exp(
        -(((yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2) / 0.02)
    )
    noise = rng.rand(n, size, size).astype(np.float32) * 0.08
    gray = np.clip(wave + 0.4 * blob + noise, 0, 1).astype(np.float32)
    for ch, w in enumerate((1.0, 0.8, 0.6)):
        images[..., ch] = gray * (w if midx % 2 else 1.0 - 0.1 * ch)
    return (images * 255).astype(np.uint8), labels


def _synthetic_split_cached(
    name: str, split: str, size: int, seed: int, root: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Disk-cached `_synthetic_split`.

    The generator is deterministic in (name, split, size, seed) but costs
    minutes of host numpy at 224², paid again on every restart. The uint8
    arrays are cached under `<root>/_synth_cache_torch/`, the port's own
    directory beside the JAX package's `_synth_cache/` (the arrays are the
    same; the port reads and writes only its own). The name is reserved for
    synthetic data, so the cache is never mistaken for real MedMNIST npz
    (`_npz_path` looks only at `<root>` top level, and callers still set
    `self.synthetic = True`). The write is atomic (tmp + rename), so a
    mid-save kill leaves no half-written cache.
    """
    if size < 112:
        # small sizes regenerate in milliseconds (tests pass fake roots at
        # these sizes): caching only pays at 112²+ where generation costs
        # minutes. The root dir is created on demand — pure-synthetic runs
        # (the main consumer of this cache) never have a data dir otherwise.
        return _synthetic_split(name, split, size, seed)
    cache_dir = os.path.join(root, "_synth_cache_torch")
    path = os.path.join(cache_dir, f"{name}_{split}_{size}_s{seed}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return np.asarray(z["images"]), np.asarray(z["labels"])
        except Exception:
            pass  # corrupt/stale cache: fall through and regenerate
    images, labels = _synthetic_split(name, split, size, seed)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, images=images, labels=labels)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only root: caching is best-effort
    return images, labels


@dataclasses.dataclass
class SplitArrays:
    """One split of one dataset, fully materialized and fixed-shape."""

    images: np.ndarray  # (N, size, size, max_channels) uint8, zero-padded
    labels: np.ndarray  # (N,) int32
    modality_idx: np.ndarray  # (N,) int32
    channels: int  # natural channel count of this modality

    def __len__(self) -> int:
        return len(self.images)


class MedMNISTSource:
    """Loads one MedMNIST dataset into fixed-shape uint8 arrays.

    Replaces the reference's MedMNISTDataset + torchvision transform stack
    (src/data/medmnist_data.py:75-251). Channel conversion (to the modality's
    natural count) and zero-padding to `max_channels` happen once here.
    """

    def __init__(
        self,
        dataset_name: str,
        split: str = "train",
        size: int = 28,
        root: str = "./data",
        max_channels: int = 3,
        synthetic_fallback: bool = True,
        seed: int = 0,
    ):
        self.dataset_name = dataset_name.lower()
        if self.dataset_name not in MODALITY_NAMES:
            raise ValueError(f"Unknown dataset: {dataset_name}")
        self.split = split
        self.size = size
        self.modality_idx = modality_index(self.dataset_name)
        self.target_channels = DATASET_CHANNELS[self.dataset_name]
        self.synthetic = False

        images, labels = self._load(root, synthetic_fallback, seed)
        images = self._apply_channel_policy(images)
        # zero-pad to the fixed max_channels layout (collate padding done once,
        # reference :50-72)
        n, h, w, c = images.shape
        if c < max_channels:
            pad = np.zeros((n, h, w, max_channels - c), images.dtype)
            images = np.concatenate([images, pad], axis=-1)
        self.arrays = SplitArrays(
            images=images,
            labels=_standardize_labels(labels),
            modality_idx=np.full((n,), self.modality_idx, np.int32),
            channels=self.target_channels,
        )

    def _npz_path(self, root: str) -> Optional[str]:
        candidates = [
            os.path.join(root, f"{self.dataset_name}_{self.size}.npz"),
            os.path.join(root, f"{self.dataset_name}.npz"),
        ]
        for p in candidates:
            if os.path.exists(p):
                return p
        return None

    def _load(self, root: str, synthetic_fallback: bool, seed: int):
        path = self._npz_path(root)
        if path is not None:
            with np.load(path) as z:
                images = np.asarray(z[f"{self.split}_images"])
                labels = np.asarray(z[f"{self.split}_labels"])
            if images.ndim == 3:
                images = images[..., None]
            images = _resize_nearest(images.astype(np.uint8), self.size)
            return images, labels
        if not synthetic_fallback:
            raise FileNotFoundError(
                f"No MedMNIST npz for {self.dataset_name} (size {self.size}) under "
                f"{root} and synthetic_fallback=False"
            )
        self.synthetic = True
        return _synthetic_split_cached(
            self.dataset_name, self.split, self.size, seed, root
        )

    def _apply_channel_policy(self, images: np.ndarray) -> np.ndarray:
        c = images.shape[-1]
        if self.target_channels == 1 and c == 3:
            return _rgb_to_gray(images.astype(np.float32)).astype(np.uint8)
        if self.target_channels == 3 and c == 1:
            return np.repeat(images, 3, axis=-1)
        return images

    def __len__(self) -> int:
        return len(self.arrays)


class MedMNISTDataModule:
    """Multi-dataset module: concatenated splits as single fixed-shape arrays.

    Replaces the reference MedMNISTDataModule (src/data/medmnist_data.py:254-470):
    ConcatDataset → array concatenation; DataLoader workers → the DeviceFeeder
    (data/pipeline.py), which copies uint8 batches to the card.
    Normalization (x·2−1) and train-time augmentation run on the device.
    """

    def __init__(
        self,
        dataset_names: Sequence[str],
        batch_size: int = 32,
        num_workers: int = 0,  # accepted for config parity; host feed is array-sliced
        size: int = 28,
        root: str = "./data",
        normalize: bool = True,
        augment_train: bool = True,
        synthetic_fallback: bool = True,
        seed: int = 0,
        **_: object,  # swallow reference-only keys (task_type, num_classes, ...)
    ):
        self.dataset_names = [n.lower() for n in dataset_names]
        self.batch_size = batch_size
        self.size = size
        self.root = root
        self.normalize = normalize
        self.augment_train = augment_train
        self.synthetic_fallback = synthetic_fallback
        self.seed = seed
        self.num_modalities = len(MODALITY_NAMES)
        self.max_channels = max(DATASET_CHANNELS[n] for n in self.dataset_names)
        self.modality_channels = {
            n: DATASET_CHANNELS[n] for n in self.dataset_names
        }
        self._splits: Dict[str, SplitArrays] = {}
        # (dataset, split) pairs that fell back to the synthetic generator —
        # surfaced as loud banners by the trainer/evaluate CLI so synthetic
        # results are never mistaken for real-MedMNIST results
        self.synthetic_datasets: set = set()

    def synthetic_banner(self, verb: str = "training") -> Optional[str]:
        """Loud banner when any split fell back to the synthetic generator
        (None otherwise). One source of truth for the trainer and the
        evaluate CLI so the warning wording can't drift."""
        if not self.synthetic_datasets:
            return None
        names = sorted({d for d, _ in self.synthetic_datasets})
        return (
            "=" * 72
            + "\n!! SYNTHETIC DATA: no MedMNIST npz found for "
            + ", ".join(names)
            + f" under '{self.root}' — {verb} on the structured synthetic"
              " generator. Metrics are NOT comparable to real-MedMNIST"
              " results.\n"
            + "=" * 72
        )

    def setup(self, stage: Optional[str] = None) -> None:
        wanted: List[str] = []
        if stage in ("fit", None):
            wanted += ["train", "val"]
        if stage in ("test", None):
            wanted += ["test"]
        for split in wanted:
            self._setup_split(split)

    def _setup_split(self, split: str) -> None:
        if split in self._splits:
            return
        sources = [
            MedMNISTSource(
                name,
                split=split,
                size=self.size,
                root=self.root,
                max_channels=self.max_channels,
                synthetic_fallback=self.synthetic_fallback,
                seed=self.seed,
            )
            for name in self.dataset_names
        ]
        for src in sources:
            if src.synthetic:
                self.synthetic_datasets.add((src.dataset_name, split))
        parts = [s.arrays for s in sources]
        self._splits[split] = SplitArrays(
            images=np.concatenate([p.images for p in parts]),
            labels=np.concatenate([p.labels for p in parts]),
            modality_idx=np.concatenate([p.modality_idx for p in parts]),
            channels=self.max_channels,
        )

    def split(self, name: str) -> SplitArrays:
        """The split's arrays, made on first use (that split alone, so an
        evaluation of the test split makes no training split)."""
        self._setup_split(name)
        return self._splits[name]

    @property
    def train_arrays(self) -> SplitArrays:
        return self.split("train")

    @property
    def val_arrays(self) -> SplitArrays:
        return self.split("val")

    @property
    def test_arrays(self) -> SplitArrays:
        return self.split("test")
