"""Conditional VAE with one-hot modality conditioning (counterpart of
medvae_tpu/models/conditional_vae.py:49-195), by `condition_method`:

  * `concat`: the one-hot condition goes through `condition_proj` (Linear
    cond_dim → C·8·8, in the compute dtype) and a ReLU, is viewed as a
    (C, 8, 8) image in torch Unflatten order, resized bilinearly to the
    input's h × w by core/resize.py in fp32 (jax.image.resize's "linear";
    F.interpolate's bilinear backward adds with atomics on the card, so two
    identical steps could differ) and concatenated after the image's
    channels before the encoder, whose conv_in therefore takes 2·C;
  * `inject`: `condition_embedding` (Linear cond_dim → 512, ReLU, Linear
    512 → 512, flax's Sequential names `layers_0`/`layers_2`) makes a temb
    that every encoder res block adds through its `temb_proj`;
  * `film`: one `FiLMLayer` a level (`film_{i}`, sized hidden·ch_mult[i])
    turns the condition into a per-channel (scale, shift) applied after that
    level's blocks.
Every conditioning layer computes in the compute dtype, as a flax Dense with
`dtype=` does. The decoder is unconditional. `num_modalities` is accepted and
ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.resize import resize
from portbench.reference.base_vae import BaseVAE, to_nchw, to_nhwc
from portbench.reference.blocks import dense

CONDITION_METHODS = ("concat", "inject", "film")
INJECT_WIDTH = 512  # the condition embedding's width (medvae_tpu/models/conditional_vae.py:109-113)

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


class FiLMLayer(nn.Module):
    """Feature-wise linear modulation of one level (medvae_tpu/models/
    conditional_vae.py:49-72): per-channel scale and shift of the condition."""

    def __init__(self, condition_dim: int, feature_dim: int):
        super().__init__()
        self.scale_transform = nn.Linear(condition_dim, feature_dim)
        self.shift_transform = nn.Linear(condition_dim, feature_dim)

    def modulation(self, condition: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift), (b, feature_dim) each, in `dtype`."""
        return dense(self.scale_transform, condition, dtype), dense(self.shift_transform, condition, dtype)


class ConditionEmbedding(nn.Module):
    """The inject method's condition MLP: Dense 512 -> ReLU -> Dense 512,
    named as flax's nn.Sequential names its layers."""

    def __init__(self, condition_dim: int):
        super().__init__()
        self.layers_0 = nn.Linear(condition_dim, INJECT_WIDTH)
        self.layers_2 = nn.Linear(INJECT_WIDTH, INJECT_WIDTH)

    def forward(self, condition: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(self.layers_2, F.relu(dense(self.layers_0, condition, dtype)), dtype)


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
        use_linear_attn: bool = False,
        attn_type: str = "vanilla",
        modalities: Optional[Sequence[str]] = None,
        condition_dim: Optional[int] = None,
        condition_method: str = "concat",
        num_modalities: Optional[int] = None,  # accepted and ignored
    ):
        if condition_method not in CONDITION_METHODS:
            raise ValueError(f"condition_method {condition_method!r}: expected one of {CONDITION_METHODS}")
        concat = condition_method == "concat"
        super().__init__(
            input_channels=input_channels, latent_dim=latent_dim,
            hidden_channels=hidden_channels, ch_mult=ch_mult,
            num_res_blocks=num_res_blocks, attn_resolutions=attn_resolutions,
            resolution=resolution, double_z=double_z, dropout=dropout,
            use_linear_attn=use_linear_attn, attn_type=attn_type,
            encoder_in_channels=2 * int(input_channels) if concat else None,
            encoder_temb_channels=INJECT_WIDTH if condition_method == "inject" else 0,
        )
        self.condition_method = condition_method
        self.modality_list = tuple(modalities) if modalities else DEFAULT_MODALITIES
        self.cond_dim = int(condition_dim or len(self.modality_list))
        if concat:
            self.condition_proj = nn.Linear(self.cond_dim, self.input_channels * 8 * 8)
        elif condition_method == "inject":
            self.condition_embedding = ConditionEmbedding(self.cond_dim)
        else:
            for i, mult in enumerate(self.ch_mult):
                self.add_module(f"film_{i}", FiLMLayer(self.cond_dim, int(hidden_channels) * mult))

    def create_condition_map(
        self, condition: torch.Tensor, height: int, width: int
    ) -> torch.Tensor:
        """Linear -> ReLU -> (C, 8, 8) -> bilinear resize to (height, width),
        in the compute dtype; NHWC out (medvae_tpu/models/conditional_vae.py:115-126)."""
        dt = self.dtype
        cmap = F.relu(dense(self.condition_proj, condition.to(self.condition_proj.weight.device), dt))
        cmap = to_nhwc(cmap.view(condition.shape[0], self.input_channels, 8, 8))
        return resize(cmap.float(), (height, width), "linear").to(dt)

    def encode(
        self, x: torch.Tensor, condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x and its (b, cond_dim) one-hot condition -> (mean, logvar)
        (medvae_tpu/models/conditional_vae.py:128-152). Without a condition,
        inject and film encode unconditioned, as in JAX; concat raises, its
        encoder taking 2·C channels."""
        if condition is None:
            if self.condition_method == "concat":
                raise ValueError("the concat ConditionalVAE encodes an image with its condition")
            return super().encode(x, generator)
        if self.condition_method == "inject":
            temb = self.condition_embedding(condition.to(x.device), self.dtype)
            return super().encode(x, generator, temb=temb)
        if self.condition_method == "film":
            film = [getattr(self, f"film_{i}").modulation(condition.to(x.device), self.dtype)
                    for i in range(len(self.ch_mult))]
            return super().encode(x, generator, film=film)
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
