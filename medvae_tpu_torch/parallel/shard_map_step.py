"""The data-parallel train steps over torch.distributed (counterpart of
medvae_tpu/parallel/shard_map_step.py).

Each rank takes its rows of the global batch (core/mesh.py:Mesh.local_rows),
runs the model on them, and:

  * for a DisentangledConditionalVAE computes the two batch-global losses,
    modality separation and InfoNCE contrastive, with the model's own
    methods on the gathered latent and modality indices
    (parallel/collectives.py:all_gather_rows, whose backward is JAX's
    psum_scatter), so the step is the single-process step on the global
    batch and not an approximation over per-rank sub-batches;
  * pmeans the loss dict and the gradients over the batch group (one flat
    all_reduce each; the identity, bit for bit, on one rank);
  * applies the optimizer scaled by `lr_scale`, then the EMA, and reports
    `train/grad_norm` of the pmean'd gradients.

The GAN step (`build_shard_map_gan_step`) runs the discriminator with sync-BN
(nn/discriminator.py:NLayerDiscriminator.sync), pmeans the two conv_out
gradients before the adaptive weight (train/step.py's `kernel_grad_sync`),
pmeans the generator's and the discriminator's gradients and the logs, and
applies both optimizers under `lr_scale`.

Both return a `TrainStep` (train/step.py), so the Trainer calls them as its
own step and a fused chunk (train/multistep.py) captures their `run`.

Noise: each rank draws from the generator its caller seeds; `rank_seed`
gives `fold_in(fold_in(seed, step), batch rank)`, where JAX folds the axis
index into its key (a deliberate difference; the tests feed
`batch["noise"]`). As in JAX, the explicit steps refuse a dcn mesh;
`build_dp_train_step` is the same step over the (dcn, data) batch group,
which the Trainer's default path takes on any mesh (torch has no SPMD
partitioner, so one formulation serves both of JAX's options).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.core.mesh import Mesh
from medvae_tpu_torch.core.rng import fold_in
from medvae_tpu_torch.models import DisentangledConditionalVAE
from medvae_tpu_torch.parallel.collectives import all_gather_rows, pmean, pmean_dict
from medvae_tpu_torch.train.optim import Optimizer
from medvae_tpu_torch.train.step import (TrainStep, _gan_grads_of, _grads_or_zeros, make_criterion,
                                         make_forward_fn, make_gan_loss)

_DCN_REFUSAL = ("the explicit shard_map steps address the single-slice (data, model) mesh; "
                "cross-host (dcn) training uses the default path (core/mesh.py, "
                "python -m medvae_tpu_torch.parallel.dcn_dryrun)")


def rank_seed(seed: int, step: int, mesh: Optional[Mesh]) -> int:
    """The step generator's seed on this rank: `fold_in(seed, step)`, with
    the batch rank folded in when the batch is split."""
    s = fold_in(seed, step)
    return s if mesh is None or mesh.batch_extent == 1 else fold_in(s, mesh.batch_rank)


def build_dp_train_step(
    model,
    loss_cfg: Dict[str, Any],
    tx: Optimizer,
    mesh: Mesh,
    *,
    augment: bool = False,
    normalize: bool = True,
    max_channels: int = 3,
    ema_decay: float = 0.0,
    accumulate_grad_batches: int = 1,
    nan_checks: bool = False,
) -> TrainStep:
    """The data-parallel step over `mesh`'s batch group (see the module
    docstring)."""
    group = mesh.group("batch")
    forward = make_forward_fn(model)
    criterion = make_criterion(loss_cfg, model)
    disentangled = isinstance(model, DisentangledConditionalVAE)

    def run_grads(state, x, batch, generator, d_valid):
        tracing.section("step.forward")
        outputs = forward(x, batch, generator)
        if disentangled:
            z_all = all_gather_rows(outputs["z"], group)
            midx_all = all_gather_rows(batch["modality_idx"], group)
            outputs = dict(outputs)
            outputs["separation_loss"] = model.modality_separation_loss(z_all, midx_all)
            outputs["contrastive_loss"] = model.contrastive_loss(z_all, midx_all)
        loss_dict = criterion(state.frozen, outputs, x)
        tracing.section("step.backward")
        grads = _grads_or_zeros(loss_dict["loss"], list(state.params.values()))
        grads = pmean(grads, group)
        loss_dict = pmean_dict({k: v.detach() for k, v in loss_dict.items()}, group)
        return (grads,), {f"train/{k}": v for k, v in loss_dict.items()}

    def optimizers(state):
        return [(tx, list(state.params.values()), state.opt_state)]

    return TrainStep(run_grads, optimizers, grad_norm=True, ema_decay=ema_decay,
                     accumulate_grad_batches=accumulate_grad_batches, augment=augment,
                     max_channels=max_channels, compute_dtype=model.dtype, normalize=normalize,
                     nan_checks=nan_checks)


def build_dp_gan_step(
    model,
    loss_cfg: Dict[str, Any],
    tx: Optimizer,
    mesh: Mesh,
    disc,
    disc_tx: Optimizer,
    *,
    augment: bool = False,
    normalize: bool = True,
    max_channels: int = 3,
    ema_decay: float = 0.0,
    accumulate_grad_batches: int = 1,
    nan_checks: bool = False,
) -> TrainStep:
    """The data-parallel GAN step over `mesh`'s batch group. Puts `disc`
    in sync-BN over that group."""
    group = mesh.group("batch")
    disc.sync(group)
    gan_grads = _gan_grads_of(model, disc, loss_cfg, kernel_grad_sync=lambda t: pmean([t], group)[0])

    def run_grads(state, x, batch, generator, d_valid):
        g_grads, d_grads, logs = gan_grads(state, x, batch, generator, d_valid)
        # sync-BN made the running statistics the same on every rank
        return (pmean(g_grads, group), pmean(d_grads, group)), pmean_dict(logs, group)

    def optimizers(state):
        return [(tx, list(state.params.values()), state.opt_state),
                (disc_tx, list(state.disc_params.values()), state.disc_opt_state)]

    return TrainStep(run_grads, optimizers, gan_loss=make_gan_loss(loss_cfg), ema_decay=ema_decay,
                     accumulate_grad_batches=accumulate_grad_batches, augment=augment,
                     max_channels=max_channels, compute_dtype=model.dtype, normalize=normalize,
                     nan_checks=nan_checks)


def build_shard_map_train_step(
    model,
    loss_cfg: Dict[str, Any],
    tx: Optimizer,
    mesh: Mesh,
    *,
    augment: bool = False,
    normalize: bool = True,
    max_channels: int = 3,
    donate: bool = True,
    ema_decay: float = 0.0,
    nan_checks: bool = False,
) -> TrainStep:
    """JAX's `build_shard_map_train_step(model, loss_cfg, tx, mesh, ...)`:
    returns step(state, batch, generator) -> (state, metrics) on this rank's
    rows; the params update in place (`donate` is accepted for the JAX
    signature). Raises on a dcn mesh, as JAX does."""
    del donate
    if mesh.dcn > 1:
        raise NotImplementedError(_DCN_REFUSAL)
    return build_dp_train_step(model, loss_cfg, tx, mesh, augment=augment, normalize=normalize,
                               max_channels=max_channels, ema_decay=ema_decay, nan_checks=nan_checks)


def build_shard_map_gan_step(
    model,
    loss_cfg: Dict[str, Any],
    tx: Optimizer,
    mesh: Mesh,
    disc,
    disc_tx: Optimizer,
    *,
    augment: bool = False,
    normalize: bool = True,
    max_channels: int = 3,
    donate: bool = True,
    ema_decay: float = 0.0,
    nan_checks: bool = False,
) -> TrainStep:
    """JAX's `build_shard_map_gan_step`: the dual-optimizer GAN step with
    sync-BN and the global adaptive weight. Raises on a dcn mesh."""
    del donate
    if mesh.dcn > 1:
        raise NotImplementedError(_DCN_REFUSAL)
    return build_dp_gan_step(model, loss_cfg, tx, mesh, disc, disc_tx, augment=augment,
                             normalize=normalize, max_channels=max_channels, ema_decay=ema_decay,
                             nan_checks=nan_checks)
