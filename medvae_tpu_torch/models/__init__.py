from medvae_tpu_torch.models.base_vae import BaseVAE
from medvae_tpu_torch.models.beta_vae import BetaVAE
from medvae_tpu_torch.models.conditional_vae import DEFAULT_MODALITIES, ConditionalVAE
from medvae_tpu_torch.models.disentangled_conditional_vae import (
    MODALITY_CHANNEL_MAP,
    DisentangledConditionalVAE,
)

__all__ = [
    "BaseVAE", "BetaVAE", "ConditionalVAE", "DisentangledConditionalVAE",
    "DEFAULT_MODALITIES", "MODALITY_CHANNEL_MAP",
]
