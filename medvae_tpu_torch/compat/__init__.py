"""Migration into the port: reference Lightning checkpoints (torch_import)
and the JAX package's params (jax_params)."""

from medvae_tpu_torch.compat.torch_import import convert_state_dict, import_lightning_checkpoint

__all__ = ["convert_state_dict", "import_lightning_checkpoint"]
