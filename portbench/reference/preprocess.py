"""A frozen copy of the port's batch preprocessing (data/pipeline.py:
augment_draws, rotate_batch, normalize_and_augment, preprocess): uint8 NHWC to
[-1, 1] in the compute dtype, the augmentation from given draws, the channel
mask."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


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
