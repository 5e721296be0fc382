"""Base VAE (counterpart of medvae_tpu/models/base_vae.py:35-156).

Public methods take and return NHWC tensors, as the JAX package's do, so the
two are compared like with like; the codec runs NCHW inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from medvae_tpu_torch.nn.encoder_decoder import Decoder, Encoder


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BaseVAE(nn.Module):
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
        encoder_in_channels: Optional[int] = None,
        encoder_temb_channels: int = 0,
    ):
        """`encoder_in_channels`: the width the encoder takes when it is not
        the image's (the concat ConditionalVAE's 2·C); `encoder_temb_channels`:
        the width of the temb its res blocks take (the inject ConditionalVAE's
        512), 0 for none."""
        super().__init__()
        self.input_channels = int(input_channels)
        self.latent_dim = int(latent_dim)
        self.ch_mult = tuple(ch_mult)
        self.resolution = int(resolution)
        self.encoder = Encoder(
            ch=hidden_channels,
            num_res_blocks=num_res_blocks,
            attn_resolutions=tuple(attn_resolutions),
            in_channels=int(encoder_in_channels or self.input_channels),
            resolution=self.resolution,
            z_channels=self.latent_dim,
            ch_mult=self.ch_mult,
            double_z=double_z,
            dropout=dropout,
            use_linear_attn=use_linear_attn,
            attn_type=attn_type,
            temb_channels=encoder_temb_channels,
        )
        self.decoder = Decoder(
            ch=hidden_channels,
            out_ch=self.input_channels,
            num_res_blocks=num_res_blocks,
            attn_resolutions=tuple(attn_resolutions),
            resolution=self.resolution,
            z_channels=self.latent_dim,
            ch_mult=self.ch_mult,
            dropout=dropout,
            use_linear_attn=use_linear_attn,
            attn_type=attn_type,
        )

    @property
    def encoder_out_res(self) -> int:
        return self.resolution // (2 ** (len(self.ch_mult) - 1))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the convs' `compute_dtype` when set (fp32
        params for training), else the dtype their weights are stored in."""
        conv = self.decoder.conv_in
        return conv.compute_dtype or conv.weight.dtype

    def encode(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
        temb: Optional[torch.Tensor] = None,
        film: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC image -> (mean, logvar), each NHWC, split on channels;
        `generator` draws the dropout masks in train mode; `temb` and `film`
        condition the encoder (nn/encoder_decoder.py)."""
        h = to_nhwc(self.encoder(to_nchw(x), generator, temb, film))
        mean, logvar = torch.chunk(h, 2, dim=-1)
        return mean, logvar

    def decode(self, z: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return to_nhwc(self.decoder(to_nchw(z), generator))

    @staticmethod
    def reparameterize(
        mean: torch.Tensor,
        logvar: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """mean + noise·exp(½ logvar) (medvae_tpu/models/base_vae.py:113-129).
        `noise` is the caller's standard-normal draw (so that tests can feed
        both packages the same one); without it, one is drawn from
        `generator` (a torch.Generator on mean's device, or the default)."""
        std = torch.exp(0.5 * logvar)
        if noise is None:
            noise = torch.randn(
                std.shape, generator=generator, dtype=torch.float32, device=std.device
            )
        return mean + noise.to(std.dtype) * std

    def forward(
        self,
        x: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The JAX model's __call__ (medvae_tpu/models/base_vae.py:131-150) on
        NHWC x: encode, reparameterize (`noise` or a draw from `generator`),
        decode; in train mode the dropout masks come from `generator` too."""
        mean, logvar = self.encode(x, generator)
        z = self.reparameterize(mean, logvar, noise=noise, generator=generator)
        return {"reconstruction": self.decode(z, generator), "mean": mean, "logvar": logvar, "z": z}

    def sample(
        self,
        num_samples: int,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Decode a prior draw of the spatial latent (NHWC); `noise` replaces
        the draw from `generator` (medvae_tpu/models/base_vae.py:152-156)."""
        r = self.encoder_out_res
        dev = self.decoder.conv_in.weight.device
        if noise is None:
            noise = torch.randn(
                (num_samples, r, r, self.latent_dim),
                generator=generator, dtype=torch.float32, device=dev,
            )
        return self.decode(noise.to(device=dev, dtype=self.dtype))
