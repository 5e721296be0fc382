"""`_target_` instantiation (counterpart of medvae_tpu/config/instantiate.py).

The `configs/` tree names the JAX package's classes (`medvae_tpu.models.*`,
`medvae_tpu.data.MedMNISTDataModule`) and the reference's (`src.models.*`,
`src.data.MedMNISTDataModule`). The port maps each onto its own class and
never imports the JAX package; a target outside the map raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from medvae_tpu_torch import models
from medvae_tpu_torch.data.medmnist import MedMNISTDataModule

_TARGETS: Dict[str, Callable] = {
    **{f"{pkg}.{name}": getattr(models, name)
       for pkg in ("medvae_tpu.models", "src.models")
       for name in ("BaseVAE", "BetaVAE", "ConditionalVAE", "DisentangledConditionalVAE")},
    "medvae_tpu.data.MedMNISTDataModule": MedMNISTDataModule,
    "src.data.MedMNISTDataModule": MedMNISTDataModule,
}


def instantiate(cfg: Any, **extra_kwargs: Any) -> Any:
    """Build the object a config node with a `_target_` describes; keys that
    start with `_` are directives, the rest constructor kwargs (nested
    `_target_` nodes are built first). Other nodes pass through."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        return cfg
    target = cfg["_target_"]
    if target not in _TARGETS:
        raise NotImplementedError(f"config target {target!r} has no counterpart in the port")
    kwargs = {k: instantiate(v) for k, v in cfg.items() if not k.startswith("_")}
    kwargs.update(extra_kwargs)
    return _TARGETS[target](**kwargs)
