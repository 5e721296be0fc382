"""Vanilla-VAE walkthrough on the PyTorch port (the twin of
examples/vanilla_vae_walkthrough.py, script form of the reference's
notebooks/vanilla_vae_interactive.ipynb explorer).

Trains a tiny BaseVAE on ChestMNIST (the shipped chest_base_vae_quick
experiment) through the port's Trainer, then:
  * reconstructs validation images
  * samples from the prior
  * interpolates between two latents
  * projects the latent space to 2-D (PCA)

Run:  python examples/vanilla_vae_walkthrough_torch.py [--device cpu] [--epochs 2]
On the card by default (`--device cuda`), where the GroupNorm+SiLU sites run
the fused kernels unless MEDVAE_FUSED_GN=0. Figures are PNGs written
without matplotlib and land in ./examples_out/vanilla_torch/.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--out", default="examples_out/vanilla_torch")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from medvae_tpu_torch.analysis import latent_interpolation, pca
    from medvae_tpu_torch.cli.train import default_config_dir
    from medvae_tpu_torch.config import compose
    from medvae_tpu_torch.data import DeviceFeeder
    from medvae_tpu_torch.data.pipeline import normalize_and_augment
    from medvae_tpu_torch.train import Trainer
    from medvae_tpu_torch.utils.visualization import (
        plot_reconstructions,
        plot_samples,
        save_image_grid,
        scatter_plot,
    )

    os.makedirs(args.out, exist_ok=True)

    # --- train a tiny model -------------------------------------------------
    cfg = compose(
        default_config_dir(),
        overrides=[
            "experiment=chest_base_vae_quick",
            f"device={args.device}",
            f"training.max_epochs={args.epochs}",
            "early_stopping.enabled=false",
        ],
    )
    trainer = Trainer(cfg)
    trainer.fit()
    model = trainer.model.eval()
    device = trainer.device

    with torch.no_grad():
        # --- reconstructions ------------------------------------------------
        feeder = DeviceFeeder(trainer.datamodule.val_arrays, 16, device, shuffle=False, drop_last=False)
        batch = next(iter(feeder.epoch(0)))
        x = normalize_and_augment(batch["image_u8"], augment=False, dtype=model.dtype)
        out = model(x, generator=torch.Generator(device).manual_seed(0))
        plot_reconstructions(
            x.float().cpu().numpy(), out["reconstruction"].float().cpu().numpy(),
            os.path.join(args.out, "reconstructions.png"),
        )

        # --- prior samples --------------------------------------------------
        samples = model.sample(16, torch.Generator(device).manual_seed(1))
        plot_samples(samples.float().cpu().numpy(), os.path.join(args.out, "prior_samples.png"))

        # --- latent interpolation -------------------------------------------
        z = out["mean"]
        path = latent_interpolation(z[0], z[1], steps=8)
        decoded = model.decode(path.to(model.dtype))
        save_image_grid(decoded.float().cpu().numpy(), os.path.join(args.out, "interpolation.png"))

        # --- latent projection ----------------------------------------------
        z_flat = out["mean"].float().reshape(len(x), -1)
        projected = pca(z_flat, 2)[0].cpu().numpy()
        scatter_plot(projected, batch["label"].cpu().numpy(), os.path.join(args.out, "latent_pca.png"))
    recon_mse = float(((out["reconstruction"].float() - x.float()) ** 2).mean())
    print(f"reconstruction mse:     {recon_mse:.4f}")
    print(f"Walkthrough figures written to {args.out}/")
    return {"recon_mse": recon_mse, "figures": sorted(os.listdir(args.out))}


if __name__ == "__main__":
    main()
