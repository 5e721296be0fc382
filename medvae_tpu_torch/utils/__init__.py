from medvae_tpu_torch.utils.logging import MetricLogger
from medvae_tpu_torch.utils.training_utils import (
    EarlyStopping,
    count_parameters,
    ema_update,
    gradient_penalty,
)

__all__ = [
    "EarlyStopping",
    "count_parameters",
    "ema_update",
    "gradient_penalty",
    "MetricLogger",
]
