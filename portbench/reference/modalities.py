"""Modality names of the 12 MedMNIST datasets, in the order whose index is the
modality index (the port's copy of medvae_tpu/data/medmnist.py:32-45,88-89)."""

from __future__ import annotations

from typing import Tuple

MODALITY_NAMES: Tuple[str, ...] = (
    "chestmnist",
    "pathmnist",
    "octmnist",
    "pneumoniamnist",
    "dermamnist",
    "bloodmnist",
    "tissuemnist",
    "retinamnist",
    "breastmnist",
    "organamnist",
    "organcmnist",
    "organsmnist",
)


def modality_index(name: str) -> int:
    return MODALITY_NAMES.index(name.lower())
