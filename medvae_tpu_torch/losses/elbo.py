"""ELBO-family losses (counterpart of medvae_tpu/losses/elbo.py:27-109).

Each loss returns fp32 scalars in a dict {"loss", "recon_loss", "kl_loss", ...}.
`DisentangledVAELoss` sums the KL over all elements and divides by the number
of target elements, scrubs every term of NaN/±inf, and turns a non-finite total
into the sentinel 1e6, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F


def gaussian_kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(N(mean, exp(½ logvar)) ‖ N(0, 1)) in fp32."""
    mean = mean.float()
    logvar = logvar.float()
    return -0.5 * (1.0 + logvar - mean.square() - torch.exp(logvar))


def _recon_loss(recon: torch.Tensor, target: torch.Tensor, kind: str) -> torch.Tensor:
    recon = recon.float()
    target = target.float()
    if kind == "mse":
        return (recon - target).square().mean()
    if kind == "l1":
        return (recon - target).abs().mean()
    if kind == "bce":  # binary_cross_entropy_with_logits, mean reduction
        return (F.relu(recon) - recon * target + torch.log1p(torch.exp(-recon.abs()))).mean()
    raise ValueError(f"Unknown reconstruction loss type: {kind}")


def _scrub(x: torch.Tensor, replacement: float = 0.0) -> torch.Tensor:
    """NaN and ±inf -> `replacement` (the reference's per-term guards)."""
    return torch.nan_to_num(x, nan=replacement, posinf=replacement, neginf=replacement)


@dataclasses.dataclass(frozen=True)
class VAELoss:
    """recon + KL, optionally β-scaled (covers VAELoss and BetaVAE)."""

    recon_loss_type: str = "mse"
    kl_weight: float = 1.0
    recon_weight: float = 1.0
    beta: float = 1.0

    def __call__(
        self, outputs: Dict[str, torch.Tensor], targets: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        recon = _recon_loss(outputs["reconstruction"], targets, self.recon_loss_type)
        kl = gaussian_kl(outputs["mean"], outputs["logvar"]).mean()
        total = self.recon_weight * recon + self.kl_weight * self.beta * kl
        return {"loss": total, "recon_loss": recon, "kl_loss": kl}


@dataclasses.dataclass(frozen=True)
class DisentangledVAELoss:
    """recon + KL/numel + separation + contrastive, NaN-proof."""

    recon_loss_type: str = "mse"
    kl_weight: float = 1.0
    recon_weight: float = 1.0
    separation_weight: float = 0.1
    contrastive_weight: float = 0.05

    def __call__(
        self, outputs: Dict[str, torch.Tensor], targets: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        recon = _scrub(_recon_loss(outputs["reconstruction"], targets, self.recon_loss_type))
        kl = gaussian_kl(outputs["mu"], outputs["logvar"]).sum()
        kl = _scrub(kl / targets.numel())
        separation = _scrub(outputs["separation_loss"].float())
        contrastive = _scrub(outputs["contrastive_loss"].float())
        total = (
            self.recon_weight * recon
            + self.kl_weight * kl
            + self.separation_weight * separation
            + self.contrastive_weight * contrastive
        )
        total = torch.nan_to_num(total, nan=1e6, posinf=1e6, neginf=1e6)
        return {
            "loss": total,
            "recon_loss": recon,
            "kl_loss": kl,
            "separation_loss": separation,
            "contrastive_loss": contrastive,
        }
