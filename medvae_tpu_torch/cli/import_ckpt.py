"""`import_ckpt` entry point (counterpart of medvae_tpu/cli/import_ckpt.py):
migrate a reference Lightning `.ckpt` into a port checkpoint that every CLI
here takes (generate, evaluate, analyze, serve).

    python -m medvae_tpu_torch.cli.import_ckpt --ckpt epoch=7-val_loss=0.036.ckpt \\
        --experiment multi_modal_cvae_quick --output_dir imported_run

The experiment and overrides must give the architecture the checkpoint was
trained with (the role the Hydra config played in the reference run).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Import a reference PyTorch Lightning checkpoint")
    p.add_argument("--ckpt", required=True, help="Lightning .ckpt file")
    p.add_argument("--experiment", default=None,
                   help="experiment config matching the checkpoint's architecture")
    p.add_argument("--override", action="append", default=[],
                   help="extra hydra-style config overrides (repeatable)")
    p.add_argument("--output_dir", default="imported")
    args = p.parse_args(argv)

    from medvae_tpu_torch.cli.train import default_config_dir
    from medvae_tpu_torch.compat.torch_import import import_lightning_checkpoint
    from medvae_tpu_torch.config.compose import compose

    overrides = list(args.override)
    if args.experiment:
        overrides.insert(0, f"experiment={args.experiment}")
    cfg = compose(default_config_dir(), "config", overrides)

    path = import_lightning_checkpoint(args.ckpt, cfg, args.output_dir)
    print(f"Checkpoint ready: {path}")
    print("Use it like any run checkpoint, e.g.\n"
          f"  python -m medvae_tpu_torch.cli.evaluate --model_path {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
