"""`analyze-latent` entry point — modality-separation audit of the latent
space (counterpart of medvae_tpu/cli/analyze.py).

    python -m medvae_tpu_torch.cli.analyze --model_path <snapshot> [--device cpu]

Encodes up to N validation samples a modality (the encoder's mean, no
noise), or with `--generated` draws N conditional prior latents a modality
(from a generator seeded with `core.rng.fold_in(--seed, modality)`, so they
differ from JAX's). On the device: the class-centroid distance matrix, the
silhouette score and a 2-D PCA (analysis/latent.py); for the flagship also
the centroid distance and silhouette of the z_modality subspace, which the
verdict reads (thresholds: distance > 10 and silhouette > 0.5 excellent,
> 3 or > 0.2 partial). Writes `latent_analysis.npz` (with a t-SNE where
sklearn is installed) and `results.json`, then the 2×3 figure
`latent_analysis.png`, which needs matplotlib and is skipped with a printed
line without it. `--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from medvae_tpu_torch.analysis.latent import centroid_distance_matrix, pca, silhouette_score
from medvae_tpu_torch.cli.common import load_model_and_params, resolve_device, seeded
from medvae_tpu_torch.cli.evaluate import figure_skipped
from medvae_tpu_torch.config.instantiate import instantiate
from medvae_tpu_torch.core.rng import fold_in
from medvae_tpu_torch.data.modalities import MODALITY_NAMES
from medvae_tpu_torch.data.pipeline import DeviceFeeder, preprocess
from medvae_tpu_torch.models import ConditionalVAE, DisentangledConditionalVAE


@torch.no_grad()
def encode_batch(model, batch):
    """(flattened encoder means, the flagship's z_modality or None)."""
    x = preprocess(batch, None, augment=False, max_channels=batch["image_u8"].shape[-1],
                   dtype=model.dtype)
    zm = None
    if isinstance(model, DisentangledConditionalVAE):
        mu, _ = model.encode(x, batch["modality_idx"])
        # z_modality: the subspace the separation and contrastive losses
        # act on (models/disentangled_conditional_vae.py:partition_latent)
        _, zm = model.partition_latent(mu)
    elif isinstance(model, ConditionalVAE):
        mu, _ = model.encode(x, batch["modality_onehot"])
    else:
        mu, _ = model.encode(x)
    return mu.reshape(mu.shape[0], -1), zm


def _collect_latents(model, datamodule, per_modality: int, device):
    """Encode val samples, bucketing ≤per_modality latents per modality."""
    split = datamodule.split("val")
    feeder = DeviceFeeder(split, datamodule.batch_size, device, shuffle=False, drop_last=False, seed=0)
    wanted = np.unique(split.modality_idx)
    buckets: dict = {}
    zm_buckets: dict = {}
    for batch in feeder.epoch(0):
        mu, zm = encode_batch(model, batch)
        mu = mu.float().cpu().numpy()
        zm = zm.float().cpu().numpy() if zm is not None else mu[:, :0]
        midx = batch["modality_idx"].cpu().numpy()
        valid = batch["valid"].cpu().numpy() > 0
        for m in np.unique(midx[valid]):
            have = sum(len(a) for a in buckets.get(int(m), []))
            if have < per_modality:
                sel = (midx == m) & valid
                buckets.setdefault(int(m), []).append(mu[sel][: per_modality - have])
                zm_buckets.setdefault(int(m), []).append(zm[sel][: per_modality - have])
        if all(sum(len(a) for a in buckets.get(m, [])) >= per_modality for m in wanted):
            break
    latents = np.concatenate([np.concatenate(v) for v in buckets.values()])
    labels = np.concatenate([np.full(sum(len(a) for a in v), m) for m, v in buckets.items()])
    zm_latents = np.concatenate([np.concatenate(v) for v in zm_buckets.values()])
    return latents, labels, (zm_latents if zm_latents.shape[1] else None)


def _generate_latents(model, per_modality: int, seed: int, device):
    """Latents of conditional samples (analyze_latent_space_simple.py path)."""
    assert isinstance(model, DisentangledConditionalVAE)
    r = model.encoder_out_res
    zs, labels = [], []
    for m in range(model.num_modalities):
        z = torch.randn((per_modality, r, r, model.total_latent_dim), device=device,
                        generator=seeded(device, fold_in(seed, m)))
        shift = (float(m) - 2.0) * 0.3
        zs.append((z + shift).reshape(per_modality, -1).cpu().numpy())
        labels.append(np.full(per_modality, m))
    return np.concatenate(zs), np.concatenate(labels)


def _figure(path, latents, labels, num_classes, proj_pca, evr, proj_tsne, dists, per_dim_var, text):
    """The 2×3 figure: PCA / t-SNE / raw-2D scatters, the centroid heatmap,
    per-dimension variance bars and the verdict."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    names = [MODALITY_NAMES[m] if m < len(MODALITY_NAMES) else str(m) for m in range(num_classes)]

    def scatter(ax, pts, title):
        for m in range(num_classes):
            sel = labels == m
            if sel.any():
                ax.scatter(pts[sel, 0], pts[sel, 1], s=8, alpha=0.6, label=names[m])
        ax.set_title(title)
        ax.legend(fontsize=7)

    scatter(axes[0, 0], proj_pca, f"PCA (evr {np.asarray(evr).sum():.2f})")
    if proj_tsne is not None:
        scatter(axes[0, 1], proj_tsne, "t-SNE")
    else:
        axes[0, 1].set_title("t-SNE unavailable")
    scatter(axes[0, 2], latents[:, :2], "raw dims 0-1")
    im = axes[1, 0].imshow(dists, cmap="viridis")
    axes[1, 0].set_title("centroid pairwise distances")
    axes[1, 0].set_xticks(range(num_classes), names, rotation=45, fontsize=7)
    axes[1, 0].set_yticks(range(num_classes), names, fontsize=7)
    fig.colorbar(im, ax=axes[1, 0])
    axes[1, 1].bar(np.arange(min(64, len(per_dim_var))), per_dim_var[:64])
    axes[1, 1].set_title("per-dimension latent variance")
    axes[1, 2].axis("off")
    axes[1, 2].text(0.05, 0.5, text, fontsize=12, va="center")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Latent-space modality-separation analysis")
    p.add_argument("--model_path", "--checkpoint", dest="model_path", required=True,
                   help="checkpoint (--checkpoint: reference "
                        "analyze_latent_space_simple.py alias)")
    p.add_argument("--config", default=None)
    p.add_argument("--samples_per_modality", "--num_samples",
                   dest="samples_per_modality", type=int, default=200,
                   help="samples per modality (--num_samples: reference alias)")
    p.add_argument("--output_dir", default="latent_analysis")
    p.add_argument("--generated", action="store_true",
                   help="analyze sampled latents instead of encoded val data")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model, cfg = load_model_and_params(args.model_path, args.config, device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.generated:
        latents, labels = _generate_latents(model, args.samples_per_modality, args.seed, device)
        zm_latents = None
    else:
        datamodule = instantiate(dict(cfg["data"]))
        latents, labels, zm_latents = _collect_latents(model, datamodule, args.samples_per_modality,
                                                       device)

    num_classes = int(labels.max()) + 1
    # device-side analytics
    z_dev, labels_dev = torch.from_numpy(latents).to(device), torch.from_numpy(labels).to(device)
    dists, counts = centroid_distance_matrix(z_dev, labels_dev, num_classes)
    sil = float(silhouette_score(z_dev, labels_dev, num_classes))
    proj_pca, evr = pca(z_dev, 2)
    dists, proj_pca, evr = (t.cpu().numpy() for t in (dists, proj_pca, evr))
    del z_dev
    per_dim_var = np.var(latents, axis=0)
    present = counts.cpu().numpy() > 0
    pair_mask = np.triu(np.ones_like(dists, bool), 1) & present[:, None] & present[None, :]
    mean_centroid_dist = float(dists[pair_mask].mean()) if pair_mask.any() else 0.0

    # z_modality subspace metrics (disentangled models): the separation and
    # contrastive losses act only on these dims, so this is the subspace the
    # memo's thresholds describe; full-latent numbers are reported alongside.
    zm_dist = zm_sil = None
    if zm_latents is not None:
        zm_dev = torch.from_numpy(zm_latents).to(device)
        zd, _ = centroid_distance_matrix(zm_dev, labels_dev, num_classes)
        zm_sil = float(silhouette_score(zm_dev, labels_dev, num_classes))
        zd = zd.cpu().numpy()
        zm_dist = float(zd[pair_mask].mean()) if pair_mask.any() else 0.0

    v_dist = zm_dist if zm_dist is not None else mean_centroid_dist
    v_sil = zm_sil if zm_sil is not None else sil
    verdict = (
        "EXCELLENT separation" if v_dist > 10 and v_sil > 0.5
        else "partial separation" if v_dist > 3 or v_sil > 0.2
        else "POOR separation"
    )
    proj_tsne = None
    try:
        from sklearn.manifold import TSNE

        perplexity = max(2, min(30, len(latents) // 4))
        proj_tsne = TSNE(n_components=2, perplexity=perplexity,
                         random_state=42, init="pca").fit_transform(latents)
    except ImportError as e:
        figure_skipped("t-SNE of latent_analysis.npz and its panel", e)

    np.savez(
        os.path.join(args.output_dir, "latent_analysis.npz"),
        latents=latents, labels=labels, centroid_distances=dists, pca=proj_pca,
        **({"tsne": proj_tsne} if proj_tsne is not None else {}),
    )
    results = {"mean_centroid_distance": mean_centroid_dist, "silhouette_score": sil,
               "verdict": verdict}
    if zm_dist is not None:
        results["zmod_centroid_distance"] = zm_dist
        results["zmod_silhouette_score"] = zm_sil
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)

    text = f"mean centroid distance: {mean_centroid_dist:.3f}\nsilhouette score: {sil:.3f}\n"
    if zm_dist is not None:
        text += f"z_modality centroid distance: {zm_dist:.3f}\nz_modality silhouette: {zm_sil:.3f}\n"
    text += f"\nverdict: {verdict}\n(targets: dist > 10, silhouette > 0.5)"
    try:
        _figure(os.path.join(args.output_dir, "latent_analysis.png"), latents, labels, num_classes,
                proj_pca, evr, proj_tsne, dists, per_dim_var, text)
    except ImportError as e:
        figure_skipped("latent_analysis.png", e)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
