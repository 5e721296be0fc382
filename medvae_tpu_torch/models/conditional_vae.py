"""Conditional VAE with one-hot modality conditioning, the `concat` method
(counterpart of medvae_tpu/models/conditional_vae.py:75-195).

The one-hot condition goes through `condition_proj` (Linear cond_dim → C·8·8,
in the compute dtype) and a ReLU, is viewed as a (C, 8, 8) image in torch
Unflatten order, resized bilinearly to the input's h × w by core/resize.py
in fp32 (jax.image.resize's "linear"; F.interpolate's bilinear backward adds
with atomics on the card, so two identical steps could differ) and
concatenated after the image's channels before the encoder, whose conv_in
therefore takes 2·C. The decoder is unconditional. `num_modalities` is accepted and ignored, as in
the JAX package. The `inject` and `film` methods are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from medvae_tpu_torch.core.resize import resize
from medvae_tpu_torch.models.base_vae import BaseVAE, to_nchw, to_nhwc

DEFAULT_MODALITIES: Tuple[str, ...] = (
    "chest_xray",
    "pathology",
    "oct",
    "pneumonia",
    "dermatoscope",
    "blood_cell",
    "tissue",
    "retina",
    "breast_ultrasound",
    "abdominal_ct_a",
    "abdominal_ct_c",
    "abdominal_ct_s",
)


class ConditionalVAE(BaseVAE):
    def __init__(
        self,
        input_channels: int = 1,
        latent_dim: int = 128,
        hidden_channels: int = 128,
        ch_mult: Sequence[int] = (1, 2, 4, 8),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (16,),
        resolution: int = 224,
        double_z: bool = True,
        dropout: float = 0.0,
        modalities: Optional[Sequence[str]] = None,
        condition_dim: Optional[int] = None,
        condition_method: str = "concat",
        num_modalities: Optional[int] = None,  # accepted and ignored
    ):
        if condition_method != "concat":
            raise NotImplementedError(
                f"condition_method {condition_method!r} is not ported yet (only 'concat')"
            )
        super().__init__(
            input_channels=input_channels, latent_dim=latent_dim,
            hidden_channels=hidden_channels, ch_mult=ch_mult,
            num_res_blocks=num_res_blocks, attn_resolutions=attn_resolutions,
            resolution=resolution, double_z=double_z, dropout=dropout,
            encoder_in_channels=2 * int(input_channels),
        )
        self.modality_list = tuple(modalities) if modalities else DEFAULT_MODALITIES
        self.cond_dim = int(condition_dim or len(self.modality_list))
        self.condition_proj = nn.Linear(self.cond_dim, self.input_channels * 8 * 8)

    def create_condition_map(
        self, condition: torch.Tensor, height: int, width: int
    ) -> torch.Tensor:
        """Linear -> ReLU -> (C, 8, 8) -> bilinear resize to (height, width),
        in the compute dtype; NHWC out (medvae_tpu/models/conditional_vae.py:115-126)."""
        dt = self.dtype
        w = self.condition_proj.weight.to(dt)
        b = self.condition_proj.bias.to(dt)
        cmap = F.relu(F.linear(condition.to(device=w.device, dtype=dt), w, b))
        cmap = to_nhwc(cmap.view(condition.shape[0], self.input_channels, 8, 8))
        return resize(cmap.float(), (height, width), "linear").to(dt)

    def encode(
        self, x: torch.Tensor, condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x and its (b, cond_dim) one-hot condition -> (mean, logvar)."""
        if condition is None:
            raise ValueError("the concat ConditionalVAE encodes an image with its condition")
        cmap = self.create_condition_map(condition, x.shape[1], x.shape[2])
        h = self.encoder(torch.cat([to_nchw(x), to_nchw(cmap).to(x.dtype)], dim=1), generator)
        mean, logvar = torch.chunk(to_nhwc(h), 2, dim=-1)
        return mean, logvar

    def forward(
        self,
        x: torch.Tensor,
        condition: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The JAX model's __call__ (:155-177) on NHWC x."""
        mean, logvar = self.encode(x, condition, generator)
        z = self.reparameterize(mean, logvar, noise=noise, generator=generator)
        return {"reconstruction": self.decode(z, generator), "mean": mean, "logvar": logvar, "z": z,
                "condition": condition}

    def conditional_sample(
        self,
        num_samples: int,
        condition: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """A prior sample decoded; the decoder is unconditional (:179-186)."""
        del condition
        return self.sample(num_samples, generator=generator, noise=noise)

    def get_modality_condition(self, modality: str) -> np.ndarray:
        """Host-side one-hot of a modality name (:188-195)."""
        if modality not in self.modality_list:
            raise ValueError(f"Unknown modality: {modality}")
        onehot = np.zeros(len(self.modality_list), dtype=np.float32)
        onehot[self.modality_list.index(modality)] = 1.0
        return onehot
