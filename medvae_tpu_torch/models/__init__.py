from medvae_tpu_torch.models.base_vae import BaseVAE
from medvae_tpu_torch.models.disentangled_conditional_vae import (
    MODALITY_CHANNEL_MAP,
    DisentangledConditionalVAE,
)

__all__ = ["BaseVAE", "DisentangledConditionalVAE", "MODALITY_CHANNEL_MAP"]
