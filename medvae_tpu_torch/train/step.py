"""The train and eval steps (counterpart of
medvae_tpu/train/step.py:119-225,402-537,659-795).

`build_train_step(model, loss_cfg, tx, ...)` returns
`step(state, batch, generator=None, draws=None) -> (state, metrics)`, the JAX
package's standard single-optimizer path: preprocess (uint8 → [−1, 1], the
channel mask, optional augmentation) in the model's compute dtype, the forward
pass, the criterion, gradients of the loss, the optimizer update scaled by
`lr_scale`, the optional EMA, and metrics `train/<term>` plus `train/grad_norm`
(of the raw gradients). The model's params are updated in place.

Random draws come from `generator` (a torch.Generator on the batch's device):
the reparameterization noise unless `batch["noise"]` is given, and the
augmentation draws unless `draws` is given. So a test can pin both.

`build_eval_step(model, loss_cfg, ...)` returns `eval_step(state, batch,
generator=None) -> metrics`: the forward in eval mode (no dropout; the
reparameterization still draws, from `generator` or `batch["noise"]`), the
criterion and the reconstruction, KL and latent metrics, all masked by the
batch's `valid`, as `val/<name>` fp32 scalars on the device; plus the sums a
whole-split validation needs: `val/_weight`, `val/_psnr_by_mod`,
`val/_count_by_mod` and, for the flagship, `val/_zmod_sum_by_mod`.

Not ported yet (later slices): `accumulate_grad_batches` > 1, the GAN path
(`lpips_discriminator`) and the tower-only loss types (`lpips`, `biomedclip`)
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from medvae_tpu_torch.data.modalities import MODALITY_NAMES
from medvae_tpu_torch.data.pipeline import preprocess
from medvae_tpu_torch.losses.elbo import DisentangledVAELoss, VAELoss
from medvae_tpu_torch.losses.graft import graft_npz
from medvae_tpu_torch.losses.perceptual import BiomedCLIPLoss, LPIPSLoss
from medvae_tpu_torch.models import ConditionalVAE, DisentangledConditionalVAE
from medvae_tpu_torch.train.metrics import kl_metrics, latent_metrics, psnr, reconstruction_metrics
from medvae_tpu_torch.train.optim import Optimizer, global_norm
from medvae_tpu_torch.train.state import TrainState

def _towers(loss_cfg: Dict[str, Any]):
    """(LPIPS loss or None, CLIP loss or None, their weights) of a
    `disentangled_vae` config. The towers compute in fp32, the JAX package's
    default `tower_dtype` (medvae_tpu/train/step.py:147-158); its bf16 option
    is set by no config and is not ported."""
    p_w = float(loss_cfg.get("perceptual_weight", 0.0) or 0.0)
    bc_w = float(loss_cfg.get("biomedclip_weight", 0.0) or 0.0)
    if str(loss_cfg.get("tower_dtype", "float32") or "float32") != "float32":
        raise NotImplementedError("only fp32 loss towers are ported")
    lp = LPIPSLoss() if p_w else None
    bc = BiomedCLIPLoss(encoder=loss_cfg.get("clip_encoder", "simple")) if bc_w else None
    return lp, bc, p_w, bc_w


def make_frozen(loss_cfg: Dict[str, Any], device, seed: int = 0) -> Dict[str, torch.nn.Module]:
    """The frozen towers `loss_cfg` needs, with random weights from fixed
    seeds (seed + 11 for LPIPS, seed + 13 for CLIP, as bench.py folds them),
    then the pretrained npz of `loss.weights_path` (LPIPS) and
    `loss.clip_weights_path` (CLIP) grafted over them where set, as
    medvae_tpu/train/trainer.py:218-233 does."""
    if str(loss_cfg.get("type", "vae")) != "disentangled_vae":
        return {}
    lp, bc, _, _ = _towers(loss_cfg)
    frozen = {}
    if lp is not None:
        frozen["lpips"] = lp.init(seed + 11, device)
        if loss_cfg.get("weights_path"):
            graft_npz(frozen["lpips"], str(loss_cfg["weights_path"]), "LPIPS")
    if bc is not None:
        frozen["clip"] = bc.init(seed + 13, device)
        if loss_cfg.get("clip_weights_path"):
            graft_npz(frozen["clip"], str(loss_cfg["clip_weights_path"]), "CLIP")
    return frozen


def make_criterion(loss_cfg: Dict[str, Any], model) -> Callable:
    """criterion(frozen, outputs, targets) -> dict of fp32 scalar losses,
    for the `vae` and `disentangled_vae` loss types; the tower-only and GAN
    types are not ported yet."""
    loss_type = str(loss_cfg.get("type", "vae"))
    if loss_type == "vae":
        beta = float(model.beta) if loss_cfg.get("use_model_beta") and hasattr(model, "beta") else 1.0
        crit = VAELoss(
            recon_loss_type=loss_cfg.get("recon_loss_type", "mse"),
            kl_weight=float(loss_cfg.get("kl_weight", 1.0)),
            recon_weight=float(loss_cfg.get("recon_weight", 1.0)),
            beta=beta,
        )
        return lambda frozen, outputs, targets: crit(outputs, targets)

    if loss_type == "disentangled_vae":
        crit = DisentangledVAELoss(
            recon_loss_type=loss_cfg.get("recon_loss_type", "mse"),
            kl_weight=float(loss_cfg.get("kl_weight", 1.0)),
            recon_weight=float(loss_cfg.get("recon_weight", 1.0)),
            separation_weight=float(loss_cfg.get("separation_weight", 0.1)),
            contrastive_weight=float(loss_cfg.get("contrastive_weight", 0.05)),
        )
        lp, bc, p_w, bc_w = _towers(loss_cfg)

        def criterion(frozen, outputs, targets):
            d = crit(outputs, targets)
            total = d["loss"]
            if lp is not None:
                d["p_loss"] = torch.nan_to_num(lp(frozen["lpips"], targets, outputs["reconstruction"]))
                total = total + p_w * d["p_loss"]
            if bc is not None:
                d["bc_loss"] = torch.nan_to_num(bc(frozen["clip"], targets, outputs["reconstruction"]))
                total = total + bc_w * d["bc_loss"]
            d["loss"] = total
            return d

        return criterion

    if loss_type in ("lpips", "biomedclip", "lpips_discriminator"):
        raise NotImplementedError(f"loss type {loss_type!r} is not ported yet")
    raise ValueError(f"Unknown loss type: {loss_type}")


def make_forward_fn(model: torch.nn.Module) -> Callable:
    """forward(x, batch, generator) -> outputs dict, by model family
    (medvae_tpu/train/step.py:55-98): the flagship takes the batch's
    `modality_idx`, the ConditionalVAE its `modality_onehot`, Base and Beta
    nothing. `batch["noise"]`, when given, is the reparameterization draw."""
    if isinstance(model, DisentangledConditionalVAE):
        return lambda x, batch, gen: model(x, batch["modality_idx"], noise=batch.get("noise"),
                                           generator=gen)
    if isinstance(model, ConditionalVAE):
        return lambda x, batch, gen: model(x, batch["modality_onehot"], noise=batch.get("noise"),
                                           generator=gen)
    return lambda x, batch, gen: model(x, noise=batch.get("noise"), generator=gen)


def build_loss_and_grads(
    model: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    *,
    augment: bool = False,
    max_channels: int = 3,
):
    """`loss_and_grads(state, batch, generator=None, draws=None) ->
    (loss_dict, grads)`: the train step up to the gradients of the loss with
    respect to `state.params`, in their order (zeros for a param the loss
    does not reach, as jax.grad gives)."""
    criterion = make_criterion(loss_cfg, model)
    forward = make_forward_fn(model)
    compute_dtype = model.dtype

    def loss_and_grads(
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ):
        params = list(state.params.values())
        x = preprocess(
            batch, generator, augment=augment, max_channels=max_channels,
            dtype=compute_dtype, draws=draws,
        )
        outputs = forward(x, batch, generator)
        loss_dict = criterion(state.frozen, outputs, x)
        grads = torch.autograd.grad(loss_dict["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return {k: v.detach() for k, v in loss_dict.items()}, grads

    return loss_and_grads


def build_train_step(
    model: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    tx: Optimizer,
    *,
    augment: bool = False,
    max_channels: int = 3,
    ema_decay: float = 0.0,
    accumulate_grad_batches: int = 1,
):
    """The standard single-optimizer train step; see the module docstring."""
    if accumulate_grad_batches > 1:
        raise NotImplementedError("accumulate_grad_batches > 1 is not ported yet")
    loss_and_grads = build_loss_and_grads(model, loss_cfg, augment=augment, max_channels=max_channels)

    def step(
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ):
        params = list(state.params.values())
        loss_dict, grads = loss_and_grads(state, batch, generator, draws)
        metrics = {f"train/{k}": v for k, v in loss_dict.items()}
        metrics["train/grad_norm"] = global_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u * state.lr_scale)
            if ema_decay and state.ema_params is not None:
                for e, p in zip(state.ema_params.values(), params):
                    e.copy_(e * ema_decay + p * (1.0 - ema_decay))
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    return step


def build_eval_step(
    model: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    *,
    max_channels: int = 3,
    n_modalities: int = 0,
):
    """The eval step; see the module docstring. The per-modality sums are
    `max(n_modalities, 12, model.num_modalities)` wide."""
    criterion = make_criterion(loss_cfg, model)
    forward = make_forward_fn(model)
    n_mod = max(n_modalities, len(MODALITY_NAMES), int(getattr(model, "num_modalities", 0) or 0))

    @torch.no_grad()
    def eval_step(
        state: TrainState, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            x = preprocess(batch, None, augment=False, max_channels=max_channels, dtype=model.dtype)
            outputs = forward(x, batch, generator)
        finally:
            model.train(was_training)
        valid = batch.get("valid")
        metrics = {f"val/{k}": v for k, v in criterion(state.frozen, outputs, x).items()}
        for group in (reconstruction_metrics(outputs["reconstruction"], x, valid),
                      kl_metrics(outputs["mean"], outputs["logvar"], valid),
                      latent_metrics(outputs["z"], valid)):
            metrics.update({f"val/{k}": v for k, v in group.items()})
        v = valid.float() if valid is not None else torch.ones((x.shape[0],), device=x.device)
        metrics["val/_weight"] = v.sum()
        onehot = torch.nn.functional.one_hot(batch["modality_idx"].long(), n_mod).float() * v[:, None]
        per_sample = psnr(outputs["reconstruction"].float(), x.float())
        metrics["val/_psnr_by_mod"] = (per_sample[:, None] * onehot).sum(dim=0)
        metrics["val/_count_by_mod"] = onehot.sum(dim=0)
        if isinstance(model, DisentangledConditionalVAE):
            _, z_mod = model.partition_latent(outputs["z"])
            metrics["val/_zmod_sum_by_mod"] = onehot.T @ (z_mod.float() * v[:, None])
        return metrics

    return eval_step
