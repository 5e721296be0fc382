"""Evaluation metrics: PSNR, SSIM, MSE, MAE, KL and latent statistics
(counterpart of medvae_tpu/train/metrics.py).

Every metric is fp32, masked by the batch's `valid` (the eval tail padding)
and left on the device, so validation syncs once a batch, not once a metric.
SSIM is torchmetrics' algorithm as the JAX package has it: an 11×11 Gaussian
window of σ 1.5, population moments over VALID windows, channels averaged.
The data range defaults to 2.0, the width of [−1, 1] (the reference passed
1.0; see the JAX module's note).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from medvae_tpu_torch.losses.elbo import gaussian_kl


def _masked_mean(per_sample: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return per_sample.mean()
    v = valid.float()
    return (per_sample * v).sum() / torch.clamp(v.sum(), min=1.0)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR in dB."""
    axes = tuple(range(1, pred.dim()))
    mse = (pred - target).square().float().mean(dim=axes)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 2.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-sample SSIM of NHWC images: a Gaussian window as a depthwise conv
    over VALID windows, the SSIM map averaged over space and channels."""
    pred, target = pred.float(), target.float()
    c = pred.shape[-1]
    coords = torch.arange(kernel_size, dtype=torch.float32, device=pred.device) - kernel_size // 2
    g = torch.exp(-coords.square() / (2 * sigma**2))
    g = g / g.sum()
    kernel = torch.outer(g, g).expand(c, 1, kernel_size, kernel_size)

    def filt(x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=c)

    mu_p, mu_t = filt(pred), filt(target)
    var_p = filt(pred * pred) - mu_p.square()
    var_t = filt(target * target) - mu_t.square()
    cov = filt(pred * target) - mu_p * mu_t
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p.square() + mu_t.square() + c1) * (var_p + var_t + c2)
    )
    return ssim_map.mean(dim=(1, 2, 3))


def reconstruction_metrics(
    reconstruction: torch.Tensor,
    target: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    data_range: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """MSE / MAE / PSNR / SSIM, masked batch means."""
    axes = tuple(range(1, target.dim()))
    rec, tgt = reconstruction.float(), target.float()
    return {
        "mse": _masked_mean((rec - tgt).square().mean(dim=axes), valid),
        "mae": _masked_mean((rec - tgt).abs().mean(dim=axes), valid),
        "psnr": _masked_mean(psnr(rec, tgt, data_range), valid),
        "ssim": _masked_mean(ssim(rec, tgt, data_range), valid),
    }


def kl_metrics(
    mean: torch.Tensor, logvar: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """The per-sample total KL's masked mean and std, the masked mean of the
    per-sample mean KL, and the unmasked mean KL per element."""
    b = mean.shape[0]
    kl_el = gaussian_kl(mean, logvar).reshape(b, -1)
    per_sample_total = kl_el.sum(dim=1)
    v = valid.float() if valid is not None else torch.ones((b,), device=mean.device)
    n = torch.clamp(v.sum(), min=1.0)
    mean_total = (per_sample_total * v).sum() / n
    var_total = ((per_sample_total - mean_total).square() * v).sum() / n
    return {
        "kl_total": mean_total,
        "kl_mean": _masked_mean(kl_el.mean(dim=1), valid),
        "kl_std": torch.sqrt(torch.clamp(var_total, min=0.0)),
        "kl_per_dim_mean": kl_el.mean(),
    }


def to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A dict of device metrics as float64 numpy arrays, in one device-to-host
    copy (one sync a batch, not one a metric)."""
    flat = torch.cat([v.detach().reshape(-1).double() for v in metrics.values()]).cpu().numpy()
    host, i = {}, 0
    for k, v in metrics.items():
        host[k] = flat[i:i + v.numel()].reshape(v.shape)
        i += v.numel()
    return host


def latent_metrics(z: torch.Tensor, valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Latent mean, population std and the share of |z| < 0.01, per sample,
    masked batch means."""
    z2 = z.reshape(z.shape[0], -1).float()
    return {
        "latent_mean": _masked_mean(z2.mean(dim=1), valid),
        "latent_std": _masked_mean(z2.std(dim=1, correction=0), valid),
        "latent_sparsity": _masked_mean((z2.abs() < 0.01).float().mean(dim=1), valid),
    }
