"""Metric logging (counterpart of medvae_tpu/utils/logging.py).

Metrics go to a JSONL file and a CSV per run, and the composed config to
`hparams.yaml` at start; `log_images` hands image files already written to
W&B. TensorBoard (torch.utils.tensorboard) and W&B
(`wandb.enabled`) attach only when importable; files are written either way.
In a run over several ranks, rank 0 logs and the others hold a `NullLogger`.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Optional

from medvae_tpu_torch.config.compose import save_yaml


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str, config: Optional[dict] = None,
                 wandb_cfg: Optional[dict] = None):
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(self.dir, "metrics.csv")
        self._csv_fields: list[str] = []
        if os.path.exists(self._csv_path):
            with open(self._csv_path) as f:
                self._csv_fields = next(csv.reader(f), []) or []
        self._t0 = time.time()
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(self.dir, "tb"))
        except Exception:  # no tensorboard package: files only
            pass
        if config is not None:
            save_yaml(config, os.path.join(self.dir, "hparams.yaml"))
        self._wandb = None
        if wandb_cfg and wandb_cfg.get("enabled"):
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=wandb_cfg.get("project"), name=wandb_cfg.get("name"),
                                         tags=list(wandb_cfg.get("tags", [])), config=config)
            except Exception as e:
                print(f"[logger] wandb unavailable ({e}); files only")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        row = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        row["step"] = step
        row["wall_time"] = round(time.time() - self._t0, 3)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        self._append_csv(row)
        if self._tb is not None:
            for k, v in row.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def _append_csv(self, row: Dict[str, Any]) -> None:
        new_fields = [k for k in row if k not in self._csv_fields]
        if not new_fields:
            with open(self._csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_fields).writerow(row)
            return
        self._csv_fields += new_fields
        rows = []
        if os.path.exists(self._csv_path):
            with open(self._csv_path) as f:
                rows = list(csv.DictReader(f))
        with open(self._csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow(r)
            w.writerow(row)

    def log_images(self, images: Dict[str, str], step: int) -> None:
        """Log already-written image files (name -> path): they stay in the
        run directory, and W&B gets them as media where the logger has it."""
        if self._wandb is None:
            return
        try:
            import wandb  # type: ignore

            self._wandb.log({name: wandb.Image(path) for name, path in images.items()}, step=step)
        except Exception as e:
            print(f"[logger] wandb image log failed ({e})")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The logger of a rank that writes nothing (every rank but 0): the
    run directory's name, and calls that do nothing."""

    def __init__(self, log_dir: str, run_name: str):
        self.dir = os.path.join(log_dir, run_name)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        pass

    def log_images(self, images: Dict[str, str], step: int) -> None:
        pass

    def close(self) -> None:
        pass
