"""Disentangled conditional-VAE walkthrough on the PyTorch port (the twin
of examples/disentangled_vae_walkthrough.py, script form of the reference's
notebooks/conditional_disentangled_vae_interactive.ipynb).

Trains the flagship DisentangledConditionalVAE on the mixed-modality quick
experiment through the port's Trainer, then:
  * reconstructs a mixed-modality batch through the routed heads
  * draws per-modality conditional samples
  * swaps z_modality codes across samples (disentanglement probe)
  * reports modality-centroid distances and the silhouette of z_modality

Run:  python examples/disentangled_vae_walkthrough_torch.py [--device cpu]
      [--epochs 1] [--limit_batches 40]
On the card by default (`--device cuda`); set MEDVAE_FUSED_GN=1 to run the
GroupNorm+SiLU sites through the fused kernels. Figures are PNGs written
without matplotlib and land in ./examples_out/disentangled_torch/.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--limit_batches", type=int, default=40)
    p.add_argument("--out", default="examples_out/disentangled_torch")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from medvae_tpu_torch.analysis import centroid_distance_matrix, silhouette_score
    from medvae_tpu_torch.cli.train import default_config_dir
    from medvae_tpu_torch.config import compose
    from medvae_tpu_torch.data import MODALITY_NAMES, DeviceFeeder
    from medvae_tpu_torch.data.pipeline import normalize_and_augment
    from medvae_tpu_torch.train import Trainer
    from medvae_tpu_torch.utils.visualization import plot_reconstructions, save_image_grid

    os.makedirs(args.out, exist_ok=True)

    cfg = compose(
        default_config_dir(),
        overrides=[
            "experiment=disentangled_multi_modal_cvae_quick",
            f"device={args.device}",
            f"training.max_epochs={args.epochs}",
            f"+training.limit_train_batches={args.limit_batches}",
            "early_stopping.enabled=false",
            "data.batch_size=64",
        ],
    )
    trainer = Trainer(cfg)
    trainer.fit()
    model = trainer.model.eval()
    device = trainer.device

    with torch.no_grad():
        # --- mixed-modality reconstruction ----------------------------------
        feeder = DeviceFeeder(trainer.datamodule.val_arrays, 16, device, shuffle=True, drop_last=False)
        batch = next(iter(feeder.epoch(0)))
        x = normalize_and_augment(batch["image_u8"], augment=False, dtype=model.dtype)
        midx = batch["modality_idx"].long()
        out = model(x, midx, generator=torch.Generator(device).manual_seed(0))
        plot_reconstructions(
            x.float().cpu().numpy(), out["reconstruction"].float().cpu().numpy(),
            os.path.join(args.out, "reconstructions.png"),
        )

        # --- per-modality conditional samples --------------------------------
        for m in range(model.num_modalities):
            imgs = model.sample_conditional(
                8, torch.full((8,), m, dtype=torch.long, device=device), torch.Generator(device).manual_seed(m),
            )
            save_image_grid(imgs.float().cpu().numpy(), os.path.join(args.out, f"samples_{MODALITY_NAMES[m]}.png"))

        # --- modality-code swap (disentanglement probe) ----------------------
        z_s, z_m = model.partition_latent(out["z"])
        swapped = model.reconstruct_latent(z_s, z_m.flip(0))
        decoded = model.decode(swapped, midx.flip(0))
        save_image_grid(decoded.float().cpu().numpy(), os.path.join(args.out, "modality_swap.png"))

        # --- separation statistics -------------------------------------------
        dists, counts = centroid_distance_matrix(z_m, midx, model.num_modalities)
        sil = float(silhouette_score(z_m.float(), midx, model.num_modalities))
    dists, present = dists.cpu().numpy(), counts.cpu().numpy() > 0
    pair = np.triu(np.ones_like(dists, bool), 1) & present[:, None] & present[None, :]
    centroid = float(dists[pair].mean())
    print(f"mean centroid distance: {centroid:.3f}")
    print(f"silhouette score:       {sil:.3f}")
    print(f"figures in {args.out}/")
    return {"centroid_distance": centroid, "silhouette": sil, "figures": sorted(os.listdir(args.out))}


if __name__ == "__main__":
    main()
