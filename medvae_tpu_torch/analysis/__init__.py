from medvae_tpu_torch.analysis.disentanglement import (
    compute_beta_vae_metric,
    compute_classification_metrics,
    compute_disentanglement_metrics,
    compute_mig,
)
from medvae_tpu_torch.analysis.fid import fid_score, fid_score_reference_quirk
from medvae_tpu_torch.analysis.latent import (
    centroid_distance_matrix,
    latent_interpolation,
    pairwise_distances,
    pca,
    silhouette_score,
)

__all__ = [
    "centroid_distance_matrix",
    "latent_interpolation",
    "pairwise_distances",
    "pca",
    "silhouette_score",
    "fid_score",
    "fid_score_reference_quirk",
    "compute_mig",
    "compute_beta_vae_metric",
    "compute_disentanglement_metrics",
    "compute_classification_metrics",
]
