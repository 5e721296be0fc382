"""Beta-VAE (counterpart of medvae_tpu/models/beta_vae.py): BaseVAE with a β
that the loss reads under `loss.use_model_beta` (train/step.py:make_criterion);
the forward pass is BaseVAE's."""

from __future__ import annotations

from medvae_tpu_torch.models.base_vae import BaseVAE


class BetaVAE(BaseVAE):
    def __init__(self, *args, beta: float = 4.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.beta = float(beta)
