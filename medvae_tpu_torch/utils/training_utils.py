"""Training utilities (counterpart of medvae_tpu/utils/training_utils.py):
early stopping on a monitored metric, a parameter count, a functional EMA
update and the WGAN-GP gradient penalty. Schedules live in train/optim.py,
seeding in core/rng.py, the train step's own EMA in train/step.py."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from medvae_tpu_torch.core import threefry


class EarlyStopping:
    """Stop when the monitored metric has not improved for `patience` checks."""

    def __init__(self, patience: int = 20, mode: str = "min", monitor: str = "val/loss"):
        self.patience = patience
        self.mode = mode
        self.monitor = monitor
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def update(self, metrics: Dict[str, float]) -> bool:
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop


def _leaves(tree):
    """The tensors of a tensor, or of dicts, lists and tuples of them."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def count_parameters(params_or_module, verbose: bool = False) -> int:
    """Elements in a module's parameters, or in a tensor tree's leaves."""
    if isinstance(params_or_module, torch.nn.Module):
        leaves = list(params_or_module.parameters())
    else:
        leaves = _leaves(params_or_module)
    total = sum(leaf.numel() for leaf in leaves)
    if verbose:
        print(f"Total trainable parameters: {total:,}")
    return total


def ema_update(ema, params, decay: float = 0.999):
    """e·decay + p·(1 − decay) for each pair of tensors of two dicts or lists
    of the same structure; functional, as the JAX package's tree_map is."""
    if isinstance(ema, dict):
        return {k: ema_update(e, params[k], decay) for k, e in ema.items()}
    if isinstance(ema, (list, tuple)):
        return type(ema)(ema_update(e, p, decay) for e, p in zip(ema, params))
    return ema * decay + params * (1.0 - decay)


def gradient_penalty(disc: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, key: threefry.Key) -> torch.Tensor:
    """WGAN-GP: E[(‖∇_x̂ D(x̂)‖₂ − 1)²] on interpolates x̂ = α·x + (1 − α)·x̃
    of NHWC images (medvae_tpu/utils/training_utils.py:79-98). α is
    `threefry.uniform(key, (b, 1, 1, 1))`, the JAX package's draw from the
    same key bit for bit. The gradient keeps its graph, so the penalty
    trains `disc`."""
    b = real.shape[0]
    alpha = threefry.uniform(key, (b, 1, 1, 1), device=real.device).to(real.dtype)
    interp = alpha * real + (1.0 - alpha) * fake
    if not interp.requires_grad:
        interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(disc(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(grads.reshape(b, -1).square().float().sum(dim=1) + 1e-12)
    return (norms - 1.0).square().mean()
