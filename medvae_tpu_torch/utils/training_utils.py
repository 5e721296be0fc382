"""Training utilities (counterpart of medvae_tpu/utils/training_utils.py):
early stopping on a monitored metric. Schedules live in train/optim.py,
seeding in core/rng.py, the EMA in the train step."""

from __future__ import annotations

from typing import Dict, Optional


class EarlyStopping:
    """Stop when the monitored metric has not improved for `patience` checks."""

    def __init__(self, patience: int = 20, mode: str = "min", monitor: str = "val/loss"):
        self.patience = patience
        self.mode = mode
        self.monitor = monitor
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def update(self, metrics: Dict[str, float]) -> bool:
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
