from medvae_tpu_torch.data.medmnist import (
    DATASET_CHANNELS,
    MODALITY_NAMES,
    MedMNISTDataModule,
    MedMNISTSource,
    modality_index,
)
from medvae_tpu_torch.data.pipeline import DeviceFeeder

__all__ = [
    "DATASET_CHANNELS",
    "MODALITY_NAMES",
    "MedMNISTDataModule",
    "MedMNISTSource",
    "modality_index",
    "DeviceFeeder",
]
