"""Optimizers and LR schedules (counterpart of medvae_tpu/train/optim.py).

`build_optimizer` returns the JAX package's optax chain written out in
PyTorch: zero_nans → clip_by_global_norm → Adam / AdamW / SGD, with the
learning rate from `build_schedule`. It follows optax op for op, where
PyTorch's own pieces differ:

  * zero_nans zeroes NaN only and leaves ±inf;
  * the clip scales by max/norm only when norm ≥ max, with no +1e-6 (unlike
    `clip_grad_norm_`);
  * Adam's eps sits outside the sqrt (eps_root 0), and the bias corrections
    divide the moments;
  * AdamW decays every param by exactly the configured weight decay (optax's
    `add_decayed_weights`, before the learning rate), where
    torch.optim.AdamW would default to 0.01;
  * the learning rate of the k-th update is schedule(k - 1);
  * SGD is optax.sgd (medvae_tpu/train/optim.py:91-92): a momentum trace
    t ← g + momentum·t (`optimizer.momentum`, 0.9 by default; no Nesterov,
    no weight decay), the update −lr·t; the trace lives in `mu`, and `nu`
    stays empty.

Params, moments and updates are lists of tensors; `update` advances the state
in place (no second copy of the moments) and returns the updates.

An update reads nothing from the host while it runs, so a CUDA graph can
capture it (train/multistep.py): `prepare` computes the step's learning rate
and bias corrections on the host (float32, as before) and fills them into
0-d tensors on the params' device (`OptState.scalars`); `apply` is the
device arithmetic over them. `update` is the two in turn, and the captured
path runs the same `apply`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def build_schedule(
    scheduler_cfg: Optional[Dict[str, Any]], base_lr: float, steps_per_epoch: int = 1
) -> Schedule:
    """Per-step learning rate. `plateau` is metric-driven: its base schedule
    stays constant and the trainer's lr_scale does the rest, as in JAX."""
    if not scheduler_cfg:
        return lambda count: base_lr
    kind = str(scheduler_cfg.get("type", "constant")).lower()
    spe = max(1, steps_per_epoch)
    if kind in ("constant", "plateau"):
        return lambda count: base_lr
    if kind == "step":
        step_size = int(scheduler_cfg.get("step_size", 10)) * spe
        gamma = float(scheduler_cfg.get("gamma", 0.1))
        return lambda count: base_lr * gamma ** (count // step_size)
    if kind == "multistep":
        milestones = sorted(int(m) * spe for m in scheduler_cfg.get("milestones", [30, 80]))
        gamma = float(scheduler_cfg.get("gamma", 0.1))
        return lambda count: base_lr * gamma ** sum(count >= m for m in milestones)
    if kind == "exponential":
        gamma = float(scheduler_cfg.get("gamma", 0.95))
        return lambda count: base_lr * gamma ** (count // spe)
    if kind == "cosine":
        t_max = max(1, int(scheduler_cfg.get("T_max", 100)) * spe)
        alpha = float(scheduler_cfg.get("eta_min", 0.0)) / base_lr

        def cosine(count: int) -> float:
            decay = 0.5 * (1.0 + math.cos(math.pi * min(count, t_max) / t_max))
            return base_lr * ((1.0 - alpha) * decay + alpha)

        return cosine
    raise ValueError(f"Unknown scheduler type: {kind}")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclasses.dataclass
class OptState:
    count: int  # updates applied so far
    mu: List[torch.Tensor]  # first moments
    nu: List[torch.Tensor]  # second moments
    # the next update's −lr and bias corrections: 0-d fp32 on the params'
    # device, filled by Optimizer.prepare
    scalars: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    kind: str  # adam | adamw | sgd
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip: Optional[float] = 1.0
    momentum: float = 0.9  # sgd's trace decay

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        device = params[0].device if len(params) else torch.device("cpu")
        scalars = {k: torch.zeros((), dtype=torch.float32, device=device) for k in ("neg_lr", "bc1", "bc2")}
        nu = [] if self.kind == "sgd" else [torch.zeros_like(p) for p in params]
        return OptState(count=0, mu=[torch.zeros_like(p) for p in params], nu=nu, scalars=scalars)

    def _bias_correction(self, decay: float, count: int) -> float:
        return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))

    @torch.no_grad()
    def prepare(self, state: OptState) -> None:
        """Fill `state.scalars` for the update that follows `state.count`
        updates: −schedule(count) and the float32 bias corrections of
        count + 1 (each cast to float32 as a Python scalar operand is)."""
        count = state.count + 1
        values = {"neg_lr": -self.schedule(state.count), "bc1": self._bias_correction(self.b1, count),
                  "bc2": self._bias_correction(self.b2, count)}
        for name, value in values.items():
            state.scalars[name].fill_(value)

    @torch.no_grad()
    def apply(
        self, grads: Sequence[torch.Tensor], state: OptState, params: Sequence[torch.Tensor]
    ) -> List[torch.Tensor]:
        """The updates for `grads` from the prepared scalars, the moments
        advanced in place; device work only (capturable). The caller adds
        the updates to the params."""
        s = state.scalars
        grads = [torch.where(torch.isnan(g), 0.0, g.float()) for g in grads]
        if self.clip:
            norm = global_norm(grads)
            keep = norm < self.clip
            grads = [torch.where(keep, g, (g / norm) * self.clip) for g in grads]
        if self.kind == "sgd":
            for g, t in zip(grads, state.mu):
                t.copy_(g + self.momentum * t)
            return [t * s["neg_lr"] for t in state.mu]
        updates = []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * g.square() + self.b2 * v)
            u = (m / s["bc1"]) / (torch.sqrt(v / s["bc2"]) + self.eps)
            if self.kind == "adamw":
                u = u + self.weight_decay * p
            updates.append(u * s["neg_lr"])
        return updates

    def update(
        self, grads: Sequence[torch.Tensor], state: OptState, params: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], OptState]:
        """(updates, state) for `grads`: `prepare`, `apply`, and the count
        advanced. `state` is advanced in place and returned."""
        self.prepare(state)
        updates = self.apply(grads, state, params)
        state.count += 1
        return updates, state


def build_optimizer(
    optimizer_cfg: Dict[str, Any],
    scheduler_cfg: Optional[Dict[str, Any]] = None,
    steps_per_epoch: int = 1,
    gradient_clip_val: Optional[float] = 1.0,
    lr_scale: float = 1.0,
    betas_override: Optional[Tuple[float, float]] = None,
) -> Optimizer:
    """`lr_scale` multiplies the configured lr before the schedule is built,
    so a cosine's `eta_min` stays absolute (alpha = eta_min / scaled lr);
    `betas_override` replaces the configured betas."""
    kind = str(optimizer_cfg.get("type", "adamw")).lower()
    if kind not in ("adam", "adamw", "sgd"):
        raise ValueError(f"Unknown optimizer type: {kind}")
    lr = float(optimizer_cfg.get("lr", 1e-4)) * lr_scale
    betas = tuple(betas_override or optimizer_cfg.get("betas", (0.9, 0.999)))
    return Optimizer(
        kind=kind,
        schedule=build_schedule(scheduler_cfg, lr, steps_per_epoch),
        b1=float(betas[0]),
        b2=float(betas[1]),
        eps=float(optimizer_cfg.get("eps", 1e-8)),
        weight_decay=float(optimizer_cfg.get("weight_decay", 0.0)),
        clip=float(gradient_clip_val) if gradient_clip_val else None,
        momentum=float(optimizer_cfg.get("momentum", 0.9)),
    )


def discriminator_optimizer(
    optimizer_cfg: Dict[str, Any],
    scheduler_cfg: Optional[Dict[str, Any]] = None,
    steps_per_epoch: int = 1,
    gradient_clip_val: Optional[float] = 1.0,
) -> Optimizer:
    """The GAN discriminator's optimizer: the generator's at lr·0.5 with
    betas (0.5, 0.999) and the same clip (medvae_tpu/train/optim.py:103-117)."""
    return build_optimizer(optimizer_cfg, scheduler_cfg, steps_per_epoch, gradient_clip_val,
                           lr_scale=0.5, betas_override=(0.5, 0.999))
