"""`evaluate` entry point — reconstruction and latent metrics over a split
(counterpart of medvae_tpu/cli/evaluate.py).

    python -m medvae_tpu_torch.cli.evaluate --model_path <snapshot> [--device cpu]

Each batch of the split (uint8 on the device, normalized and channel-masked
there) goes through `eval_batch`: the model's forward with a reparameterized
z, then the masked reconstruction, KL and latent metrics of
train/metrics.py and the per-modality PSNR sums; one device-to-host copy a
batch. The summary holds each metric's mean/std/min/max over batches and
each present modality's PSNR, and with `--fid` the FID between the real and
reconstructed images' features, with `--mig` the MIG and β-VAE probe of the
encoder means against the modality. `metrics.json` is written first, then
the figures: `reconstructions.png` and `prior_samples.png` (PNG grids), and
`latent_tsne.png`, which needs matplotlib and sklearn and is skipped with a
printed line where either is missing.

The reparameterization noise of batch i comes from a generator seeded with
`core.rng.fold_in(--seed, i)`, the prior samples from `--seed` itself. The
FID features are the port's `BiomedCLIPLoss("simple")` tower initialised
from `fold_in(--seed, 1234)`, where JAX draws its tower from `fold_in(key,
1234)`: `fid_recon` compares within one package only. `--device` defaults
to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from medvae_tpu_torch.cli.common import load_model_and_params, resolve_device, seeded
from medvae_tpu_torch.config.instantiate import instantiate
from medvae_tpu_torch.core.rng import fold_in
from medvae_tpu_torch.data.modalities import MODALITY_NAMES
from medvae_tpu_torch.data.pipeline import DeviceFeeder, preprocess
from medvae_tpu_torch.train.metrics import kl_metrics, latent_metrics, psnr, reconstruction_metrics, to_host
from medvae_tpu_torch.train.step import make_forward_fn, prior_samples
from medvae_tpu_torch.utils.visualization import plot_reconstructions, plot_samples

FID_TOWER_STREAM = 1234  # the JAX CLI's fold_in(rng, 1234)


@torch.no_grad()
def eval_batch(
    model,
    batch: Dict[str, torch.Tensor],
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """(metrics, x, reconstruction, encoder mean) of one batch, the JAX
    CLI's jitted `eval_batch` (evaluate.py:78-108): metrics masked by the
    batch's `valid`, plus `_psnr_by_mod` and `_count_by_mod`, the valid
    per-sample PSNR sums and counts by modality (12 wide). `noise` is the
    reparameterization draw (NHWC); without it one comes from `generator`."""
    x = preprocess(batch, None, augment=False, max_channels=batch["image_u8"].shape[-1],
                   dtype=model.dtype)
    out = make_forward_fn(model)(x, {**batch, "noise": noise}, generator)
    valid = batch["valid"]
    rec = out["reconstruction"]
    m = {**reconstruction_metrics(rec, x, valid), **kl_metrics(out["mean"], out["logvar"], valid),
         **latent_metrics(out["z"], valid)}
    onehot = F.one_hot(batch["modality_idx"].long(), len(MODALITY_NAMES)).float() * valid.float()[:, None]
    per_sample = psnr(rec.float(), x.float())
    m["_psnr_by_mod"] = (per_sample[:, None] * onehot).sum(dim=0)
    m["_count_by_mod"] = onehot.sum(dim=0)
    return m, x, rec, out["mean"]


def figure_skipped(name: str, error: ImportError) -> None:
    """The one line a host figure stage prints when its plotting package is
    not installed."""
    print(f"{name} not written: {getattr(error, 'name', None) or error} is not installed")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate a trained VAE")
    p.add_argument("--model_path", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--output_dir", default="evaluation")
    p.add_argument("--max_batches", type=int, default=0, help="0 = full split")
    p.add_argument("--split", default="test")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fid", action="store_true",
                   help="FID between real and reconstructed feature distributions")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA weight average (requires "
                        "training.ema_decay > 0)")
    p.add_argument("--mig", action="store_true",
                   help="MIG / beta-VAE probe of latents vs modality factor (needs sklearn)")
    p.add_argument("--config_path", default=None,
                   help="alias of --config (reference evaluate.py)")
    p.add_argument("--num_samples", type=int, default=0,
                   help="cap evaluated samples (reference evaluate.py); "
                        "0 = full split")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model, cfg = load_model_and_params(
        args.model_path, args.config or args.config_path, use_ema=args.use_ema, device=device
    )
    datamodule = instantiate(dict(cfg["data"]))
    split = datamodule.split(args.split)
    banner = datamodule.synthetic_banner("evaluating")
    if banner:
        print(banner)
    os.makedirs(args.output_dir, exist_ok=True)
    bs = datamodule.batch_size

    feat_net = None
    real_feats: List[torch.Tensor] = []
    fake_feats: List[torch.Tensor] = []
    if args.fid:
        from medvae_tpu_torch.losses.perceptual import BiomedCLIPLoss

        bc = BiomedCLIPLoss("simple")
        feat_net = bc.init(fold_in(args.seed, FID_TOWER_STREAM), device)

        def features(img: torch.Tensor) -> torch.Tensor:
            return feat_net(bc._preprocess(img.float()))

    feeder = DeviceFeeder(split, bs, device, shuffle=False, drop_last=False, seed=args.seed)
    per_batch: Dict[str, List[float]] = {}
    psnr_by_mod_sum = np.zeros((len(MODALITY_NAMES),), np.float64)
    count_by_mod = np.zeros((len(MODALITY_NAMES),), np.float64)
    first_x = first_rec = None
    latents, latent_labels = [], []
    with torch.no_grad():
        for i, batch in enumerate(feeder.epoch(0)):
            m, x, rec, mean = eval_batch(model, batch, generator=seeded(device, fold_in(args.seed, i)))
            fetched = to_host(m)
            psnr_by_mod_sum += fetched.pop("_psnr_by_mod")
            count_by_mod += fetched.pop("_count_by_mod")
            for k, v in fetched.items():
                per_batch.setdefault(k, []).append(float(v))
            if first_x is None:
                first_x, first_rec = x.float().cpu().numpy(), rec.float().cpu().numpy()
            if len(latents) * bs < 2000:
                latents.append(mean.float().reshape(mean.shape[0], -1).cpu().numpy())
                latent_labels.append(batch["modality_idx"].cpu().numpy())
            if feat_net is not None and len(real_feats) * bs < 4000:
                valid = batch["valid"] > 0
                real_feats.append(features(x)[valid])
                fake_feats.append(features(rec)[valid])
            if args.max_batches and i + 1 >= args.max_batches:
                break
            if args.num_samples and (i + 1) * bs >= args.num_samples:
                break

    # aggregate mean/std/min/max per metric (reference evaluate.py:109-135)
    summary = {}
    for k, vals in per_batch.items():
        a = np.asarray(vals)
        summary[k] = {"mean": float(a.mean()), "std": float(a.std()),
                      "min": float(a.min()), "max": float(a.max())}
    for mi, name in enumerate(MODALITY_NAMES):
        if count_by_mod[mi] > 0:
            summary[f"psnr_{name}"] = {"mean": float(psnr_by_mod_sum[mi] / count_by_mod[mi]),
                                       "count": int(count_by_mod[mi])}
    if args.fid and real_feats:
        from medvae_tpu_torch.analysis import fid_score

        summary["fid_recon"] = {"value": fid_score(torch.cat(real_feats), torch.cat(fake_feats))}
    if args.mig and latents:
        from medvae_tpu_torch.analysis import compute_disentanglement_metrics

        try:
            dm = compute_disentanglement_metrics(np.concatenate(latents),
                                                 np.concatenate(latent_labels)[:, None])
        except ImportError as e:
            raise ImportError(f"--mig needs scikit-learn (sklearn), which is not installed: {e}") from e
        summary["mig"] = {"value": dm["mig"]}
        summary["beta_vae_metric"] = {"value": dm["beta_vae_metric"]}

    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)

    # figures (reference evaluate.py:137-168), after the numbers
    plot_reconstructions(first_x, first_rec, os.path.join(args.output_dir, "reconstructions.png"))
    with torch.no_grad():
        samples = prior_samples(model, 16, seeded(device, args.seed))
    plot_samples(samples.float().cpu().numpy(), os.path.join(args.output_dir, "prior_samples.png"),
                 title="Prior samples")
    if latents:
        from medvae_tpu_torch.utils.visualization import plot_latent_space

        try:
            plot_latent_space(np.concatenate(latents), np.concatenate(latent_labels),
                              os.path.join(args.output_dir, "latent_tsne.png"), method="tsne")
        except ImportError as e:
            figure_skipped("latent_tsne.png", e)

    print(json.dumps({k: v.get("mean", v.get("value")) for k, v in summary.items()}, indent=2))
    print(f"Saved evaluation to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
