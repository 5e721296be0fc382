"""`_target_` instantiation (counterpart of medvae_tpu/config/instantiate.py).

A target resolves as the JAX package's `_locate` resolves it: a name given to
`register_target` first; then the reference's `src.models.*` and
`src.data.*` names, mapped onto the port's classes; then any dotted path,
imported as written. The `configs/` tree names the JAX package's classes
(`medvae_tpu.models.*`, `medvae_tpu.data.MedMNISTDataModule`), so a
`medvae_tpu.` prefix is rewritten to `medvae_tpu_torch.` before the import:
the port never imports the JAX package. A rewritten path with no
counterpart in the port raises NotImplementedError naming it.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_JAX_PACKAGE = "medvae_tpu"
_PORT = "medvae_tpu_torch"

# The reference repo's target strings -> the port's dotted paths, so the
# original configs keep working verbatim.
_COMPAT_TARGETS: Dict[str, str] = {
    "src.models.BaseVAE": f"{_PORT}.models.BaseVAE",
    "src.models.BetaVAE": f"{_PORT}.models.BetaVAE",
    "src.models.ConditionalVAE": f"{_PORT}.models.ConditionalVAE",
    "src.models.DisentangledConditionalVAE": f"{_PORT}.models.DisentangledConditionalVAE",
    "src.models.NLayerDiscriminator": f"{_PORT}.nn.discriminator.NLayerDiscriminator",
    "src.data.MedMNISTDataModule": f"{_PORT}.data.medmnist.MedMNISTDataModule",
}

_REGISTRY: Dict[str, Callable] = {}


def register_target(name: str, fn: Callable) -> None:
    """Make `name` resolve to `fn`, ahead of every other rule."""
    _REGISTRY[name] = fn


def _locate(target: str) -> Callable:
    if target in _REGISTRY:
        return _REGISTRY[target]
    path = _COMPAT_TARGETS.get(target, target)
    rewritten = path.split(".", 1)[0] == _JAX_PACKAGE
    if rewritten:
        path = _PORT + path[len(_JAX_PACKAGE):]
    module_name, _, attr = path.rpartition(".")
    try:
        return getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        if rewritten:
            raise NotImplementedError(
                f"config target {target!r} has no counterpart in the port ({path})") from e
        raise


def instantiate(cfg: Any, **extra_kwargs: Any) -> Any:
    """Build the object a config node with a `_target_` describes; keys that
    start with `_` are directives, the rest constructor kwargs (nested
    `_target_` nodes are built first). Other nodes pass through."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        return cfg
    target = _locate(cfg["_target_"])
    kwargs = {k: instantiate(v) for k, v in cfg.items() if not k.startswith("_")}
    kwargs.update(extra_kwargs)
    return target(**kwargs)
