"""Disentangled Conditional VAE — the flagship model (counterpart of
medvae_tpu/models/disentangled_conditional_vae.py:45-302,390-401).

Batched modality routing, as in the JAX package:
  * per-modality 1x1 input/output projectors become stacked (M, C, C) matrices
    gathered per sample and applied as one batched product (identity for
    full-channel modalities, zero rows/columns for the channel pad/slice);
  * the M decoder heads run as one conv pair: `heads_conv1` with M·C outputs,
    ReLU, then `heads_conv2` grouped with groups=M, so that channel g·C + c
    belongs to head g; each sample's head is selected with a one-hot einsum.
Parameter names of the projectors and heads are the JAX package's
(`in_proj_kernel_{m}`, `heads_conv1`, …). `forward` is the training pass
(medvae_tpu/models/disentangled_conditional_vae.py:355-388): encode, the ±10
clamps, reparameterize, routed decode, and the batch-global separation and
contrastive losses.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.base_vae import BaseVAE, to_nchw, to_nhwc
from portbench.reference.blocks import Conv2d

# chest=1, path=3, oct=3, pneumonia=1, derm=3, then the other MedMNIST sets
# (medvae_tpu/models/disentangled_conditional_vae.py:50-53).
MODALITY_CHANNEL_MAP: Dict[int, int] = {
    0: 1, 1: 3, 2: 3, 3: 1, 4: 3,
    5: 3, 6: 3, 7: 3, 8: 3, 9: 1, 10: 1, 11: 1,
}


class DisentangledConditionalVAE(BaseVAE):
    contrastive_temperature = 0.1  # the JAX model's default (:68)

    def __init__(
        self,
        num_modalities: int = 5,
        shared_latent_dim: int = 8,
        modality_latent_dim: int = 8,
        hidden_channels: int = 128,
        ch_mult: Sequence[int] = (1, 2, 4, 8),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (16,),
        resolution: int = 224,
        double_z: bool = True,
        dropout: float = 0.0,
        use_linear_attn: bool = False,
        attn_type: str = "vanilla",
    ):
        chans = tuple(MODALITY_CHANNEL_MAP.get(m, 3) for m in range(num_modalities))
        # the base VAE runs at max_channels and the total latent
        super().__init__(
            input_channels=max(chans),
            latent_dim=int(shared_latent_dim) + int(modality_latent_dim),
            hidden_channels=hidden_channels, ch_mult=ch_mult,
            num_res_blocks=num_res_blocks, attn_resolutions=attn_resolutions,
            resolution=resolution, double_z=double_z, dropout=dropout,
            use_linear_attn=use_linear_attn, attn_type=attn_type,
        )
        self.num_modalities = int(num_modalities)
        self.shared_latent_dim = int(shared_latent_dim)
        self.modality_latent_dim = int(modality_latent_dim)
        self.modality_channels = chans
        c = self.max_channels = self.input_channels
        self.total_latent_dim = self.latent_dim
        for m, cm in enumerate(self.modality_channels):
            if cm != c:
                self.register_parameter(f"in_proj_kernel_{m}", nn.Parameter(torch.zeros(cm, c)))
                self.register_parameter(f"in_proj_bias_{m}", nn.Parameter(torch.zeros(c)))
                self.register_parameter(f"out_proj_kernel_{m}", nn.Parameter(torch.zeros(c, cm)))
                self.register_parameter(f"out_proj_bias_{m}", nn.Parameter(torch.zeros(cm)))
        mc = self.num_modalities * c
        self.heads_conv1 = Conv2d(c, mc, 3, padding=1)
        self.heads_conv2 = Conv2d(mc, mc, 3, padding=1, groups=self.num_modalities)

    # ------------------------------------------------------------------ #
    # batched modality routing                                           #
    # ------------------------------------------------------------------ #

    def _stacked_input_matrices(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M, C, C) + (M, C): matrix[m][i, j] maps input channel i to j."""
        c = self.max_channels
        dev = self.heads_conv1.weight.device
        mats = torch.eye(c, device=dev).repeat(self.num_modalities, 1, 1)
        biases = torch.zeros(self.num_modalities, c, device=dev)
        for m, cm in enumerate(self.modality_channels):
            if cm != c:
                mats[m] = 0.0
                mats[m, :cm, :] = getattr(self, f"in_proj_kernel_{m}")
                biases[m] = getattr(self, f"in_proj_bias_{m}")
        return mats, biases

    def _stacked_output_matrices(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M, C, C) + (M, C); channels a modality lacks are zero columns."""
        c = self.max_channels
        dev = self.heads_conv1.weight.device
        mats = torch.eye(c, device=dev).repeat(self.num_modalities, 1, 1)
        biases = torch.zeros(self.num_modalities, c, device=dev)
        for m, cm in enumerate(self.modality_channels):
            if cm != c:
                mats[m] = 0.0
                mats[m, :, :cm] = getattr(self, f"out_proj_kernel_{m}")
                biases[m, :cm] = getattr(self, f"out_proj_bias_{m}")
        return mats, biases

    @staticmethod
    def _route(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-sample x·w + b on NHWC x with w, b cast to x's dtype first and
        the product taken in fp32, cast back to x's dtype."""
        w = w.to(x.dtype).float()
        b = b.to(x.dtype).float()
        out = torch.einsum("bhwc,bcd->bhwd", x.float(), w) + b[:, None, None, :]
        return out.to(x.dtype)

    def _clip(self, modality_indices: torch.Tensor) -> torch.Tensor:
        return modality_indices.long().clamp(0, self.num_modalities - 1)

    def encode(
        self, x: torch.Tensor, modality_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x -> (mu, logvar). The input projection runs in x's dtype
        (fp32 for a normalized uint8 request); the cast to the compute dtype
        happens at the encoder's conv_in."""
        x = torch.nan_to_num(x)
        if modality_indices is not None:
            midx = self._clip(modality_indices)
            w, b = self._stacked_input_matrices()
            x = torch.nan_to_num(self._route(x, w[midx], b[midx]))
        h = to_nhwc(self.encoder(to_nchw(x), generator))
        mu, logvar = torch.chunk(h, 2, dim=-1)
        return torch.nan_to_num(mu), torch.nan_to_num(logvar)

    def decode(
        self, z: torch.Tensor, modality_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Base decode, then the routed heads and the output projection."""
        recon = self.decoder(to_nchw(z), generator)  # (B, C, H, W)
        if modality_indices is None:
            return to_nhwc(recon)
        bsz, c, hh, ww = recon.shape
        midx = self._clip(modality_indices)
        onehot = F.one_hot(midx, self.num_modalities).to(recon.dtype)
        h = self.heads_conv2(F.relu(self.heads_conv1(recon)))  # group g = head g
        h = h.view(bsz, self.num_modalities, c, hh, ww)
        routed = to_nhwc(torch.einsum("bmchw,bm->bchw", h, onehot))
        w, b = self._stacked_output_matrices()
        return self._route(routed, w[midx], b[midx])

    # ------------------------------------------------------------------ #
    # latent partitioning                                                #
    # ------------------------------------------------------------------ #

    def partition_latent(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split the latent, flattened in (C, H, W) order, into shared and
        modality parts."""
        z_flat = z.permute(0, 3, 1, 2).reshape(z.shape[0], -1)
        s = self.shared_latent_dim
        return z_flat[:, :s], z_flat[:, s : s + self.modality_latent_dim]

    def reconstruct_latent(
        self, z_shared: torch.Tensor, z_modality: torch.Tensor
    ) -> torch.Tensor:
        """Inverse of partition_latent, zero-padding the tail; NHWC out."""
        b = z_shared.shape[0]
        r = self.encoder_out_res
        full = r * r * self.total_latent_dim
        used = self.shared_latent_dim + self.modality_latent_dim
        pad = z_shared.new_zeros((b, full - used))
        z = torch.cat([z_shared, z_modality, pad], dim=1)
        return z.reshape(b, self.total_latent_dim, r, r).permute(0, 2, 3, 1)

    # ------------------------------------------------------------------ #
    # disentanglement losses and the training forward                    #
    # ------------------------------------------------------------------ #

    def modality_separation_loss(
        self, z: torch.Tensor, modality_indices: torch.Tensor
    ) -> torch.Tensor:
        """−mean pairwise distance between the per-modality centroids of
        z_modality over the modalities present in the batch, 0 when fewer
        than two are (JAX :304-327). sqrt(sq + 1e-12), not torch.cdist, keeps
        the gradient finite and equal to JAX's at coincident centroids."""
        _, z_mod = self.partition_latent(z)
        z_mod = z_mod.float()
        m = self.num_modalities
        # an index outside [0, M) gives a zero row, as jax.nn.one_hot does
        arange = torch.arange(m, device=z.device)
        onehot = (modality_indices.long()[:, None] == arange[None, :]).float()  # (B, M)
        counts = onehot.sum(dim=0)
        centroids = (onehot.T @ z_mod) / torch.clamp(counts, min=1.0)[:, None]
        present = counts > 0
        diff = centroids[:, None, :] - centroids[None, :, :]
        dist = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)
        upper = torch.ones((m, m), dtype=torch.bool, device=z.device).triu(diagonal=1)
        pair_mask = upper & present[:, None] & present[None, :]
        n_pairs = pair_mask.sum()
        mean_dist = torch.where(pair_mask, dist, 0.0).sum() / torch.clamp(n_pairs, min=1)
        return torch.where(n_pairs > 0, -mean_dist, 0.0)

    def contrastive_loss(
        self, z: torch.Tensor, modality_indices: torch.Tensor
    ) -> torch.Tensor:
        """InfoNCE over L2-normalized z_modality with same-modality
        positives, temperature 0.1, norm clamped at 1e-12, the +1e-8 log
        guard, averaged over the rows that have a positive (JAX :329-349)."""
        _, z_mod = self.partition_latent(z)
        z_mod = z_mod.float()
        b = z_mod.shape[0]
        norm = torch.linalg.vector_norm(z_mod, dim=1, keepdim=True)
        z_n = z_mod / torch.clamp(norm, min=1e-12)
        sim = (z_n @ z_n.T) / self.contrastive_temperature
        eye = torch.eye(b, dtype=torch.bool, device=z.device)
        same = (modality_indices[:, None] == modality_indices[None, :]) & ~eye
        exp_sim = torch.exp(sim)
        pos = torch.where(same, exp_sim, 0.0).sum(dim=1)
        all_sim = exp_sim.sum(dim=1) - torch.diagonal(exp_sim)
        per_sample = -torch.log(pos / torch.clamp(all_sim, min=1e-12) + 1e-8)
        valid = pos > 0
        n_valid = valid.sum()
        loss = torch.where(valid, per_sample, 0.0).sum() / torch.clamp(n_valid, min=1)
        return torch.where(n_valid > 0, loss, 0.0)

    def forward(
        self,
        x: torch.Tensor,
        modality_indices: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The training pass on NHWC x: the JAX model's __call__ output dict.
        `noise` (the reparameterization draw, NHWC) replaces the draw from
        `generator`."""
        if modality_indices is None:
            modality_indices = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
        mu, logvar = self.encode(x, modality_indices, generator)
        logvar = torch.clamp(logvar, -10.0, 10.0)
        mu = torch.clamp(mu, -10.0, 10.0)
        z = self.reparameterize(mu, logvar, noise=noise, generator=generator)
        reconstruction = self.decode(z, modality_indices, generator)
        return {
            "reconstruction": reconstruction,
            "mean": mu,
            "logvar": logvar,
            "mu": mu,
            "z": z,
            "separation_loss": self.modality_separation_loss(z, modality_indices),
            "contrastive_loss": self.contrastive_loss(z, modality_indices),
        }

    def sample_conditional(
        self,
        num_samples: int,
        modality_indices: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Prior sample shifted by (idx - 2)·0.3 per modality, decoded through
        the routed heads. `noise` (NHWC) replaces the draw from `generator`."""
        r = self.encoder_out_res
        dev = self.heads_conv1.weight.device
        if noise is None:
            noise = torch.randn(
                (num_samples, r, r, self.total_latent_dim),
                generator=generator, dtype=torch.float32, device=dev,
            )
        z = noise.to(device=dev, dtype=self.dtype)
        shift = (modality_indices.to(device=dev, dtype=self.dtype) - 2.0) * 0.3
        return self.decode(z + shift[:, None, None, None], modality_indices)
