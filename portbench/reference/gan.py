"""Adversarial (PatchGAN) loss with the adaptive generator weight
(counterpart of medvae_tpu/losses/gan.py).

  * `hinge_d_loss`: ½(E relu(1 − D(x)) + E relu(1 + D(x̂))) in fp32;
  * `adaptive_weight`: ‖∇ nll‖ / (‖∇ g‖ + 1e-4), clamped to [0, 1e4] and
    detached, from the two gradients with respect to the decoder's
    `conv_out` weight (the train step forms them);
  * `LPIPSWithDiscriminator`: the factors and the generator and
    discriminator heads. The adversarial terms are gated on step ≥
    `discriminator_iter_start` by multiplying by `d_valid` (0 or 1), never
    by branching, as the JAX package does: before the gate the step still
    runs D and its terms, zeroed.

The towers (LPIPS, and CLIP with `use_biomedclip_loss`) live in the train
state's `frozen` under "lpips" and "clip"; train/step.py:make_frozen makes
them, and train/step.py:make_gan_loss builds the loss from a config. Log
keys are the JAX package's, `{split}/total_loss` … `{split}/logits_fake`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from portbench.reference.perceptual import BiomedCLIPLoss, LPIPSLoss, _to_rgb
from portbench.reference.optim import global_norm


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.relu(1.0 - logits_real.float()).mean()
                  + torch.relu(1.0 + logits_fake.float()).mean())


def adaptive_weight(nll_grads: Sequence[torch.Tensor], g_grads: Sequence[torch.Tensor],
                    clip_max: float = 1e4, eps: float = 1e-4) -> torch.Tensor:
    w = global_norm(nll_grads) / (global_norm(g_grads) + eps)
    return torch.clamp(w, 0.0, clip_max).detach()


def discriminator_input(x: torch.Tensor) -> torch.Tensor:
    """Grayscale → RGB repeat for the PatchGAN (NHWC)."""
    return _to_rgb(x)


@dataclasses.dataclass
class LPIPSWithDiscriminator:
    """The factor bundle and the loss heads (the JAX class's fields;
    `pixel_factor` adds pixel_factor·mean|x − x̂| to the generator loss and
    to the adaptive weight's numerator)."""

    discriminator_factor: float = 1.0
    perceptual_factor: float = 1.0
    pixel_factor: float = 0.0
    kl_factor: float = 1.0
    discriminator_iter_start: int = 50001
    use_biomedclip_loss: bool = False
    biomedclip_factor: float = 1.0
    clip_encoder: str = "simple"
    tower_dtype: torch.dtype = torch.float32  # the towers' compute dtype (`loss.tower_dtype`)

    def __post_init__(self):
        self.perceptual_loss = LPIPSLoss(dtype=self.tower_dtype)
        self.biomed_clip_loss = (BiomedCLIPLoss(self.clip_encoder, dtype=self.tower_dtype)
                                 if self.use_biomedclip_loss else None)

    def d_valid(self, step: int) -> float:
        """1.0 from `discriminator_iter_start` on, else 0.0: computed on the
        host; the step hands it to the loss heads as a 0-d device tensor."""
        return float(int(step) >= self.discriminator_iter_start)

    @staticmethod
    def pixel_l1(inputs: torch.Tensor, reconstructions: torch.Tensor) -> torch.Tensor:
        return (inputs.float() - reconstructions.float()).abs().mean()

    def generator_loss(
        self,
        frozen: Dict[str, torch.nn.Module],
        inputs: torch.Tensor,
        reconstructions: torch.Tensor,
        kl_per_sample_sum: torch.Tensor,
        logits_fake: torch.Tensor,
        d_weight: torch.Tensor,
        d_valid: torch.Tensor,
        split: str = "train",
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`d_valid`: `self.d_valid(step)` as a 0-d fp32 tensor on the
        inputs' device."""
        p_loss = self.perceptual_loss(frozen["lpips"], inputs, reconstructions)
        pix_loss = self.pixel_l1(inputs, reconstructions)
        kl_loss = kl_per_sample_sum.float().sum() / inputs.shape[0]
        g_loss = -logits_fake.float().mean()
        eff_weight = d_valid * d_weight * self.discriminator_factor
        loss = (self.perceptual_factor * p_loss + self.pixel_factor * pix_loss
                + self.kl_factor * kl_loss + eff_weight * g_loss)
        bc_loss = None
        if self.biomed_clip_loss is not None:
            bc_loss = self.biomed_clip_loss(frozen["clip"], inputs, reconstructions)
            loss = loss + self.biomedclip_factor * bc_loss
        log = {
            f"{split}/total_loss": loss.detach(),
            f"{split}/kl_loss": kl_loss.detach(),
            f"{split}/p_loss": p_loss.detach(),
            f"{split}/d_weight": eff_weight.float().detach(),
            f"{split}/g_loss": (d_valid * g_loss).detach(),
        }
        if self.pixel_factor:
            log[f"{split}/pix_loss"] = pix_loss.detach()
        if bc_loss is not None:
            log[f"{split}/bc_loss"] = bc_loss.detach()
        return loss, log

    def rec_for_adaptive(self, frozen: Dict[str, torch.nn.Module], inputs: torch.Tensor,
                         reconstructions: torch.Tensor) -> torch.Tensor:
        """The adaptive weight's numerator objective: LPIPS, plus the pixel
        term when `pixel_factor` is set."""
        p = self.perceptual_loss(frozen["lpips"], inputs, reconstructions)
        if self.pixel_factor:
            p = p + self.pixel_factor * self.pixel_l1(inputs, reconstructions)
        return p

    def discriminator_loss(
        self, logits_real: torch.Tensor, logits_fake: torch.Tensor, d_valid: torch.Tensor,
        split: str = "train",
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        d_loss = d_valid * hinge_d_loss(logits_real, logits_fake)
        return d_loss, {
            f"{split}/d_loss": d_loss.detach(),
            f"{split}/logits_real": (d_valid * logits_real.float().mean()).detach(),
            f"{split}/logits_fake": (d_valid * logits_fake.float().mean()).detach(),
        }
