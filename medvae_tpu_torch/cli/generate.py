"""`generate` entry point — sample images from a trained port checkpoint
(counterpart of medvae_tpu/cli/generate.py).

    python -m medvae_tpu_torch.cli.generate --model_path <snapshot> [--device cpu]

It takes the JAX CLI's flags and writes its file names for each model
family: the flagship's `samples_grid.png` (modalities in turn),
`samples_<modality>.png` and `<modality>_000.png`…; the other families'
`samples_grid[_seed<S>].png` for each of `--num_seeds` seeds and
`sample_000.png`…; with `--interpolate STEPS`, `interpolation_grid.png`, one
row of STEPS decodes a path between two prior draws (one row a modality for
the flagship, else min(4, N) rows).

The noise comes from torch.Generators on the device. Where JAX folds its key
with an index (a modality, a seed offset, an interpolation row), the port
seeds a generator with `core.rng.fold_in(--seed, index)`; the interpolation
pairs take `fold_in(--seed, 7919, 0 or 1, row)`. The images therefore differ
from JAX's for the same --seed. `--device` defaults to the card and raises
without one; `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from medvae_tpu_torch.analysis.latent import latent_interpolation
from medvae_tpu_torch.cli.common import load_model_and_params, resolve_device, seeded
from medvae_tpu_torch.core.rng import fold_in
from medvae_tpu_torch.data.modalities import MODALITY_NAMES, modality_index
from medvae_tpu_torch.models import ConditionalVAE, DisentangledConditionalVAE
from medvae_tpu_torch.utils.visualization import save_image, save_image_grid

INTERPOLATION_STREAM = 7919  # the JAX CLI's fold_in(rng, 7919)


def _host(images: torch.Tensor) -> np.ndarray:
    return images.float().cpu().numpy()


def interpolation_latents(
    model, seed: int, steps: int, num_samples: int, device
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The interpolation grid's rows: for each, the (steps, r, r, latent)
    path between two prior draws and the flagship's modality indices (None
    for the other families)."""
    r = model.encoder_out_res
    disentangled = isinstance(model, DisentangledConditionalVAE)
    ld = model.total_latent_dim if disentangled else model.latent_dim
    n_rows = model.num_modalities if disentangled else min(4, num_samples)
    rows = []
    for i in range(n_rows):
        z_a, z_b = (torch.randn((r, r, ld), device=device,
                                generator=seeded(device, fold_in(seed, INTERPOLATION_STREAM, end, i))
                                ).to(model.dtype) for end in (0, 1))
        midx = torch.full((steps,), i, dtype=torch.long, device=device) if disentangled else None
        rows.append((latent_interpolation(z_a, z_b, steps=steps), midx))
    return rows


@torch.no_grad()
def interpolation_rows(model, seed: int, steps: int, num_samples: int, device) -> List[np.ndarray]:
    """Each interpolation path decoded (NHWC float32 in [-1, 1])."""
    return [_host(model.decode(path, midx) if midx is not None else model.decode(path))
            for path, midx in interpolation_latents(model, seed, steps, num_samples, device)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate samples from a trained VAE")
    p.add_argument("--model_path", required=True, help="port checkpoint (.pt or snapshot directory)")
    p.add_argument("--config", default=None, help="run config.yaml (auto-detected)")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--modality", default=None, help="e.g. chestmnist / chest_xray")
    p.add_argument("--output_dir", default="generated")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_seeds", type=int, default=1,
                   help="grids for N consecutive seeds (reference quick_generate)")
    p.add_argument("--use_ema", action="store_true",
                   help="generate from the EMA weight average (requires "
                        "training.ema_decay > 0)")
    p.add_argument("--per_modality", action="store_true",
                   help="one grid per modality (disentangled/conditional models)")
    p.add_argument("--interpolate", type=int, default=0, metavar="STEPS",
                   help="also decode STEPS-point linear interpolation paths "
                        "between prior latent pairs")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--grid_size", type=int, default=None,
                   help="columns in saved grids (reference generate.py)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model, _ = load_model_and_params(args.model_path, args.config, use_ema=args.use_ema,
                                     device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    n = args.num_samples

    def out(name: str) -> str:
        return os.path.join(args.output_dir, name)

    with torch.no_grad():
        if isinstance(model, DisentangledConditionalVAE):
            modalities = (
                [modality_index(args.modality)] if args.modality
                else list(range(model.num_modalities))
            )
            if not args.per_modality and args.modality is None:
                midx = torch.arange(n, device=device) % model.num_modalities
                imgs = model.sample_conditional(n, midx, generator=seeded(device, args.seed))
                save_image_grid(_host(imgs), out("samples_grid.png"), cols=args.grid_size)
            for m in modalities:
                midx = torch.full((n,), m, dtype=torch.long, device=device)
                imgs = _host(model.sample_conditional(
                    n, midx, generator=seeded(device, fold_in(args.seed, m))))
                name = MODALITY_NAMES[m]
                save_image_grid(imgs, out(f"samples_{name}.png"), cols=args.grid_size)
                for i in range(min(n, 8)):
                    save_image(imgs[i], out(f"{name}_{i:03d}.png"))
        else:
            if isinstance(model, ConditionalVAE) and args.modality:
                model.get_modality_condition(args.modality)  # an unknown name raises
            # the ConditionalVAE's decoder is unconditional: its samples are
            # the prior's, as the Base and Beta VAEs'
            for s in range(args.num_seeds):
                suffix = f"_seed{args.seed + s}" if args.num_seeds > 1 else ""
                imgs = _host(model.sample(n, generator=seeded(device, fold_in(args.seed, s))))
                save_image_grid(imgs, out(f"samples_grid{suffix}.png"), cols=args.grid_size)
                if s == 0:
                    for i in range(min(n, 16)):
                        save_image(imgs[i], out(f"sample_{i:03d}.png"))

    if args.interpolate > 1:
        rows = interpolation_rows(model, args.seed, args.interpolate, n, device)
        save_image_grid(np.concatenate(rows, axis=0), out("interpolation_grid.png"),
                        cols=args.interpolate)

    print(f"Saved samples to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
