"""The benchmark's inputs, made from the seed: synthetic MedMNIST-shaped
splits (uint8 NHWC at the configuration's size, three channels with the
channels a modality lacks left zero, modalities in equal shares, labels),
made on the card in one draw and kept in host memory; and the lookup that
finds which rows of a split a batch the program was fed holds.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# channels of each of the 12 MedMNIST modalities, in the modality index's
# order (chest, path, oct, pneumonia, derm, blood, tissue, retina, breast,
# organa, organc, organs): grayscale 1, RGB 3
CHANNELS = np.array([1, 3, 3, 1, 3, 3, 3, 3, 3, 1, 1, 1], np.int32)
N_MODALITIES_ALL = len(CHANNELS)
KEY_BYTES = 4096  # the leading bytes of a row that identify it


def make_split(rows: int, size: int, n_modalities: int, seed: int, device) -> Dict[str, np.ndarray]:
    """{"images" (rows, size, size, 3) uint8, "labels" (rows,) int32,
    "modality_idx" (rows,) int32} from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    images = torch.randint(0, 256, (rows, size, size, 3), generator=gen, device=device, dtype=torch.uint8)
    perm = torch.randperm(rows, generator=gen, device=device)
    midx = (perm % n_modalities).to(torch.int32)
    ch = torch.as_tensor(CHANNELS, device=device)[midx.long()]
    keep = (torch.arange(3, device=device)[None, :] < ch[:, None]).to(torch.uint8)
    images *= keep[:, None, None, :]
    labels = torch.randint(0, 2, (rows,), generator=gen, device=device, dtype=torch.int32)
    return {"images": images.cpu().numpy(), "labels": labels.cpu().numpy(),
            "modality_idx": midx.cpu().numpy()}


class RowIndex:
    """Finds a row of a split by its leading bytes (random rows never share
    them)."""

    def __init__(self, images: np.ndarray):
        flat = images.reshape(len(images), -1)[:, :KEY_BYTES]
        self._index = {flat[i].tobytes(): i for i in range(len(images))}
        if len(self._index) != len(images):
            raise ValueError("two rows of the split share their leading bytes")

    def rows_of(self, batch_images: np.ndarray) -> List[int]:
        """The split's row of each image of a batch; -1 where none is."""
        flat = batch_images.reshape(len(batch_images), -1)[:, :KEY_BYTES]
        return [self._index.get(flat[i].tobytes(), -1) for i in range(len(batch_images))]


def batch_of(split: Dict[str, np.ndarray], rows: List[int], device) -> Dict[str, torch.Tensor]:
    """The batch of `rows` as the reference takes it: uint8 images, modality
    index and its 12-wide one-hot, natural channels."""
    idx = np.asarray(rows)
    midx = torch.as_tensor(split["modality_idx"][idx].astype(np.int64), device=device)
    return {
        "image_u8": torch.as_tensor(split["images"][idx], device=device),
        "modality_idx": midx,
        "modality_onehot": torch.nn.functional.one_hot(midx, N_MODALITIES_ALL).float(),
        "channels": torch.as_tensor(CHANNELS, device=device)[midx],
        "valid": torch.ones((len(idx),), device=device),
    }
