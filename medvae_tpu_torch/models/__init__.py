from medvae_tpu_torch.models.base_vae import BaseVAE
from medvae_tpu_torch.models.beta_vae import BetaVAE
from medvae_tpu_torch.models.conditional_vae import DEFAULT_MODALITIES, ConditionalVAE, FiLMLayer
from medvae_tpu_torch.models.disentangled_conditional_vae import (
    MODALITY_CHANNEL_MAP,
    DisentangledConditionalVAE,
)
from medvae_tpu_torch.nn.discriminator import NLayerDiscriminator

__all__ = [
    "BaseVAE", "BetaVAE", "ConditionalVAE", "FiLMLayer", "DisentangledConditionalVAE",
    "DEFAULT_MODALITIES", "MODALITY_CHANNEL_MAP", "NLayerDiscriminator",
]
