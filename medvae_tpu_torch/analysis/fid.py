"""Fréchet distance between feature distributions (FID) (counterpart of
medvae_tpu/analysis/fid.py).

`fid_score` is the correct form, with the matrix square root by symmetric
eigendecompositions: torch fp32 on the features' device (the card in
cli/evaluate.py), as the JAX package computes it on its device.
`fid_score_reference_quirk` is the reference's computation, which takes the
element-wise square root of Σ₁Σ₂ (SURVEY §7), in numpy float64, for
comparison with numbers the reference produced.
"""

from __future__ import annotations

import numpy as np
import torch


def _features(feats) -> torch.Tensor:
    return (feats if isinstance(feats, torch.Tensor) else torch.from_numpy(np.asarray(feats))).float()


def _stats(feats: torch.Tensor):
    mu = feats.mean(dim=0)
    xc = feats - mu
    cov = (xc.T @ xc) / max(feats.shape[0] - 1, 1)
    return mu, cov


def fid_score(real_features, fake_features) -> float:
    """FID = ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2·(Σ₁Σ₂)^½) with a proper matrix sqrt.

    tr((Σ₁Σ₂)^½) is computed stably as Σ√λᵢ of Σ₁^½ Σ₂ Σ₁^½ (symmetric PSD).
    Tensors stay on their device; numpy arrays go to the CPU."""
    real = _features(real_features)
    mu1, s1 = _stats(real)
    mu2, s2 = _stats(_features(fake_features).to(real.device))
    diff = mu1 - mu2
    w1, v1 = torch.linalg.eigh(s1)
    s1_half = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
    wi = torch.clamp(torch.linalg.eigvalsh(s1_half @ s2 @ s1_half), min=0.0)
    fid = diff @ diff + torch.trace(s1) + torch.trace(s2) - 2.0 * torch.sqrt(wi).sum()
    return float(fid)


def fid_score_reference_quirk(real_features, fake_features) -> float:
    """The reference's computation verbatim in spirit: element-wise
    np.sqrt(Σ₁·Σ₂) (matrix product, element-wise sqrt) — WRONG math, kept only
    for comparing against numbers produced by the reference implementation."""
    real = np.asarray(real_features, np.float64)
    fake = np.asarray(fake_features, np.float64)
    mu1, s1 = real.mean(axis=0), np.cov(real, rowvar=False)
    mu2, s2 = fake.mean(axis=0), np.cov(fake, rowvar=False)
    diff = mu1 - mu2
    covmean = np.sqrt(s1.dot(s2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(s1 + s2 - 2 * covmean))
