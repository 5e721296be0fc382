"""Batched latent-space analytics on the input's device (counterpart of
medvae_tpu/analysis/latent.py).

Torch functions in fp32 with the JAX package's formulas: pairwise distances
in the Gram form with the diagonal zeroed, class centroids and their
distance matrix, the silhouette coefficient, linear interpolation, and PCA.
PCA differs in one respect: where the samples are fewer than the dimensions
(N < D, as with the 224² flagship's 100,352-wide latent, whose D×D
covariance no card decomposes in useful time) it decomposes the N×N Gram
matrix of the centered data instead. Both share their nonzero eigenvalues,
so the projections and the explained-variance ratios are the same up to each
component's sign; with D ≤ N it takes the covariance as JAX does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, N) Euclidean distances (scipy.pdist equivalent, squareform)."""
    x = x.float()
    sq = x.square().sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    # fp32 cancellation leaves ~1e-3 junk on the diagonal; it is exactly 0
    d2 = d2 * (1.0 - torch.eye(x.shape[0], dtype=torch.float32, device=x.device))
    return torch.sqrt(d2)


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def centroid_distance_matrix(
    z: torch.Tensor, labels: torch.Tensor, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class centroids of z and their pairwise distance matrix
    (analyze_latent_space.py:200-216). Returns (distances[M,M], counts[M])."""
    z = z.float()
    onehot = _onehot(labels.to(z.device), num_classes)
    counts = onehot.sum(dim=0)
    centroids = (onehot.T @ z) / torch.clamp(counts, min=1.0)[:, None]
    return pairwise_distances(centroids), counts


def pca(x: torch.Tensor, n_components: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Principal components of x's rows. Returns (projected[N,k],
    explained_variance_ratio[k]); see the module docstring for the Gram
    form taken when N < D."""
    x = x.float()
    n, d = x.shape
    xc = x - x.mean(dim=0, keepdim=True)
    denom = max(n - 1, 1)
    if n < d:
        eigvals, eigvecs = torch.linalg.eigh((xc @ xc.T) / denom)  # ascending
        idx = torch.argsort(eigvals, descending=True)[:n_components]
        lam = eigvals[idx]
        # u the Gram matrix's unit eigenvector: the covariance's is
        # xcᵀu / √(denom·λ), so the projection xc·(xcᵀu)/√(denom·λ) = √(denom·λ)·u
        proj = eigvecs[:, idx] * torch.sqrt(torch.clamp(lam * denom, min=0.0))
    else:
        eigvals, eigvecs = torch.linalg.eigh((xc.T @ xc) / denom)
        idx = torch.argsort(eigvals, descending=True)[:n_components]
        lam = eigvals[idx]
        proj = xc @ eigvecs[:, idx]
    # both matrices' eigenvalues sum to the covariance's trace
    return proj, lam / torch.clamp(eigvals.sum(), min=1e-12)


def silhouette_score(z: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mean silhouette coefficient, fully vectorized (sklearn-equivalent):
    s_i = (b_i − a_i)/max(a_i, b_i), a = mean intra-cluster distance,
    b = min over other clusters of mean distance to that cluster."""
    d = pairwise_distances(z)  # (N, N)
    labels = labels.to(d.device).long()
    onehot = _onehot(labels, num_classes)  # (N, M)
    counts = onehot.sum(dim=0)  # (M,)
    sums = d @ onehot  # sum of distances from each point to each cluster
    own_counts = counts[labels]
    own_sums = sums.gather(1, labels[:, None])[:, 0]
    a = torch.where(own_counts > 1, own_sums / torch.clamp(own_counts - 1.0, min=1.0),
                    torch.zeros_like(own_sums))
    mean_other = sums / torch.clamp(counts, min=1.0)[None, :]
    # own cluster and empty clusters masked with +inf before the min
    masked = onehot.bool() | (counts == 0)[None, :]
    b = torch.where(masked, torch.full_like(mean_other, float("inf")), mean_other).min(dim=1).values
    valid = torch.isfinite(b) & (own_counts > 1)
    s = torch.where(valid, (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12),
                    torch.zeros_like(a))
    return s.sum() / torch.clamp(valid.float().sum(), min=1.0)


def latent_interpolation(z_a: torch.Tensor, z_b: torch.Tensor, steps: int = 8) -> torch.Tensor:
    """Linear interpolation path between two latents: (steps, *z.shape).
    The weights are jnp.linspace(0, 1, steps)'s fp32 values as XLA forms
    them (i times the reciprocal of steps − 1, the last exactly 1), which
    torch.linspace rounds differently in a few ulp."""
    if steps > 1:
        inv = torch.tensor(1.0 / (steps - 1), dtype=torch.float32)
        t = torch.cat([torch.arange(steps - 1, dtype=torch.float32) * inv, torch.ones(1)])
    else:
        t = torch.zeros(steps)
    t = t.to(z_a.device).reshape(-1, *([1] * z_a.dim()))
    return z_a[None] * (1.0 - t) + z_b[None] * t
