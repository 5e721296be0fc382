"""Migration into the port: reference Lightning checkpoints (torch_import),
the JAX package's params (jax_params) and published diffusers AutoencoderKL
weights (diffusers_import)."""

from medvae_tpu_torch.compat.diffusers_import import convert_diffusers_state_dict
from medvae_tpu_torch.compat.torch_import import convert_state_dict, import_lightning_checkpoint

__all__ = ["convert_diffusers_state_dict", "convert_state_dict", "import_lightning_checkpoint"]
