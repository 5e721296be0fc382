"""Train state (counterpart of medvae_tpu/train/state.py:19-64).

`params` holds the model's trainable parameters by name: the very tensors of
the module, which the train step updates in place (the port keeps one copy of
the weights, where JAX returns a new tree). `frozen` holds the loss towers
(nn.Modules with requires_grad off) by the JAX package's keys, "lpips" and
"clip". On the GAN path (`create_train_state(..., disc=, disc_tx=)`),
`disc_params` holds the discriminator's params and `disc_batch_stats` its
BatchNorm buffers, both by name and the module's own tensors, updated in
place like `params`; `disc_opt_state` is its optimizer's state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from medvae_tpu_torch.train.optim import OptState, Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    frozen: Dict[str, torch.nn.Module] = dataclasses.field(default_factory=dict)
    # host-driven LR multiplier (ReduceLROnPlateau): scaling the final update
    # is scaling the learning rate
    lr_scale: float = 1.0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    disc_params: Optional[Dict[str, torch.Tensor]] = None
    disc_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    disc_opt_state: Optional[OptState] = None


def create_train_state(
    model: torch.nn.Module,
    tx: Optimizer,
    frozen: Optional[Dict[str, Any]] = None,
    ema_decay: float = 0.0,
    disc: Optional[torch.nn.Module] = None,
    disc_tx: Optional[Optimizer] = None,
) -> TrainState:
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if not params:
        raise ValueError("the model has no trainable params: build it with train=True")
    gan = {}
    if disc is not None:
        if disc_tx is None:
            raise ValueError("a discriminator needs its optimizer (disc_tx)")
        disc_params = dict(disc.named_parameters())
        gan = dict(disc_params=disc_params, disc_batch_stats=dict(disc.named_buffers()),
                   disc_opt_state=disc_tx.init(list(disc_params.values())))
    return TrainState(
        step=0,
        params=params,
        opt_state=tx.init(list(params.values())),
        frozen=dict(frozen or {}),
        ema_params={n: p.detach().clone() for n, p in params.items()} if ema_decay else None,
        **gan,
    )
