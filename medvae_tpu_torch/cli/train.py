"""`train` entry point (counterpart of medvae_tpu/cli/train.py).

    python -m medvae_tpu_torch.cli.train experiment=chest_base_vae_quick device=cpu ...

Composes the repo's `configs/` tree with Hydra's override syntax
(config/compose.py), writes the composed config and the overrides into the
run directory (`<log_dir>/<experiment_name>/`), then trains: seed, model,
datamodule, fit, test, final checkpoint (train/trainer.py). The device
defaults to the configs' `tpu`, which the port reads as the card; `device=cpu`
trains on the CPU. Multirun sweeps (`-m`) are not ported yet.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from medvae_tpu_torch.config.compose import compose, save_yaml


def default_config_dir() -> str:
    """$MEDVAE_CONFIG_DIR, else the nearest `configs/` with a config.yaml
    above this file."""
    env = os.environ.get("MEDVAE_CONFIG_DIR")
    if env:
        return env
    for parent in Path(__file__).resolve().parents:
        if (parent / "configs" / "config.yaml").exists():
            return str(parent / "configs")
    return "configs"


def _capture_run_dir(cfg, overrides) -> None:
    run_dir = os.path.join(cfg.get("log_dir", "logs"), cfg.get("experiment_name", "run"))
    os.makedirs(run_dir, exist_ok=True)
    save_yaml(cfg, os.path.join(run_dir, "config.yaml"))
    save_yaml(list(overrides), os.path.join(run_dir, "overrides.yaml"))


def main(argv=None) -> int:
    overrides = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("-m", "--multirun") for a in overrides):
        raise NotImplementedError("multirun sweeps (-m) are not ported yet; run one job at a time")
    cfg = compose(default_config_dir(), "config", overrides)
    _capture_run_dir(cfg, overrides)

    from medvae_tpu_torch.train.trainer import Trainer

    print(f"Experiment: {cfg.get('experiment_name')}")
    trainer = Trainer(cfg)
    val = trainer.fit()
    test = trainer.test()
    print("Validation:", {k: round(v, 5) for k, v in val.items()})
    print("Test:", {k: round(v, 5) for k, v in test.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
