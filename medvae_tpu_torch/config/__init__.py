from medvae_tpu_torch.config.compose import ConfigDict, compose, load_yaml, merge
from medvae_tpu_torch.config.instantiate import instantiate, register_target

__all__ = ["ConfigDict", "compose", "load_yaml", "merge", "instantiate", "register_target"]
