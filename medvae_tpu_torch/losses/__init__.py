from medvae_tpu_torch.losses.elbo import DisentangledVAELoss, VAELoss, gaussian_kl
from medvae_tpu_torch.losses.gan import LPIPSWithDiscriminator, hinge_d_loss
from medvae_tpu_torch.losses.perceptual import BiomedCLIPLoss, LPIPSLoss, SimpleCLIPEncoder

__all__ = [
    "VAELoss",
    "DisentangledVAELoss",
    "gaussian_kl",
    "LPIPSLoss",
    "BiomedCLIPLoss",
    "SimpleCLIPEncoder",
    "LPIPSWithDiscriminator",
    "hinge_d_loss",
]
