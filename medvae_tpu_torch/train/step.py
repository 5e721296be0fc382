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

The GAN path (`lpips_discriminator`, medvae_tpu/train/step.py:273-400,
544-657): `build_train_step(..., disc=, disc_tx=)` runs the generator and
the discriminator update in one step, in the JAX package's order. (1) The
generator forward in train mode and the KL per sample. (2) D in eval mode
(its params and running stats from before the step) on the reconstruction.
(3) The adaptive weight from the gradients of `rec_for_adaptive` and of
−mean D(x̂) with respect to the decoder's `conv_out` weight alone: on the
main graph when the model has no dropout (the same numbers as the JAX
package's decoder pass on the detached z), else from a decoder pass on the
detached z without dropout, as JAX does. (4) The generator's gradients,
taken with respect to its own params only, so none land on D. (5) D in
train mode on x, then on the detached x̂, its BatchNorm statistics updated
after each call, and the hinge loss × d_valid's gradients. (6) Both updates,
each with its own optimizer and clip and both scaled by `lr_scale`; the EMA
follows the generator. Before `discriminator_iter_start` every adversarial
term is multiplied by 0, so D still runs and moves its statistics, and adamw
still decays its params, as in the JAX package. Metrics are the loss's log
(`train/total_loss` … `train/logits_fake`), without a grad norm.

`build_train_step` returns a `TrainStep`: a callable whose host part
(`prepare`, `finish`) and device part (`run`) a CUDA graph can split, and
which splits a batch into `accumulate_grad_batches` microbatches, on the GAN
path too (see `TrainStep`).

Options of the JAX steps: `normalize=False` (`data.normalize: false`) leaves
the images in [0, 1] (medvae_tpu/train/step.py:124-132); `loss.tower_dtype`
sets the towers' compute dtype (`_tower_dtype`); `nan_checks=True`
(`debug.nan_checks`) raises FloatingPointError on the first step whose
metrics or gradients hold a NaN, before the optimizer (which zeroes NaN
gradients, as optax's zero_nans does) could hide it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from medvae_tpu_torch.core.rng import fold_in
from medvae_tpu_torch.data.modalities import MODALITY_NAMES
from medvae_tpu_torch.data.pipeline import preprocess
from medvae_tpu_torch.losses.elbo import DisentangledVAELoss, VAELoss, gaussian_kl
from medvae_tpu_torch.losses.gan import LPIPSWithDiscriminator, adaptive_weight, discriminator_input
from medvae_tpu_torch.losses.graft import graft_npz
from medvae_tpu_torch.losses.perceptual import BiomedCLIPLoss, LPIPSLoss
from medvae_tpu_torch.models import ConditionalVAE, DisentangledConditionalVAE
from medvae_tpu_torch.nn.blocks import ResnetBlock
from medvae_tpu_torch.train.metrics import kl_metrics, latent_metrics, psnr, reconstruction_metrics
from medvae_tpu_torch.train.optim import Optimizer, global_norm
from medvae_tpu_torch.train.state import TrainState

def _tower_dtype(loss_cfg: Dict[str, Any]) -> torch.dtype:
    """The towers' compute dtype, `loss.tower_dtype` (medvae_tpu/train/
    step.py:147-158): float32 by default, or bfloat16; their params stay
    fp32 and their reductions fp32 either way."""
    name = str(loss_cfg.get("tower_dtype", "float32") or "float32")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)
    if dtype is None:
        raise ValueError(f"loss.tower_dtype={name!r}: expected float32 or bfloat16")
    return dtype


def _clip_loss(loss_cfg: Dict[str, Any]) -> BiomedCLIPLoss:
    return BiomedCLIPLoss(encoder=loss_cfg.get("clip_encoder", "simple"), dtype=_tower_dtype(loss_cfg))


def _towers(loss_cfg: Dict[str, Any]):
    """(LPIPS loss or None, CLIP loss or None, their weights) of a
    `disentangled_vae` config."""
    p_w = float(loss_cfg.get("perceptual_weight", 0.0) or 0.0)
    bc_w = float(loss_cfg.get("biomedclip_weight", 0.0) or 0.0)
    lp = LPIPSLoss(dtype=_tower_dtype(loss_cfg)) if p_w else None
    bc = _clip_loss(loss_cfg) if bc_w else None
    return lp, bc, p_w, bc_w


def _tower_plan(loss_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """{"lpips": (seed offset, LPIPSLoss), "clip": (offset, BiomedCLIPLoss)}
    for the towers `loss_cfg` needs. LPIPS takes seed + 11 wherever it
    appears (the JAX Trainer folds 11 for it); CLIP takes seed + 11 as the
    `biomedclip` loss's only tower (JAX: fold 11) and seed + 13 beside LPIPS
    (JAX: fold 13 for the flagship, a split of fold 11 for the GAN)."""
    loss_type = str(loss_cfg.get("type", "vae"))
    if loss_type == "disentangled_vae":
        lp, bc, _, _ = _towers(loss_cfg)
    elif loss_type in ("lpips", "biomedclip", "lpips_discriminator"):
        lp = None if loss_type == "biomedclip" else LPIPSLoss()
        clip = loss_type == "biomedclip" or (loss_type == "lpips_discriminator"
                                             and bool(loss_cfg.get("use_biomedclip_loss")))
        bc = _clip_loss(loss_cfg) if clip else None
    else:
        return {}
    plan = {} if lp is None else {"lpips": (11, lp)}
    if bc is not None:
        plan["clip"] = (11 if loss_type == "biomedclip" else 13, bc)
    return plan


def make_frozen(loss_cfg: Dict[str, Any], device, seed: int = 0) -> Dict[str, torch.nn.Module]:
    """The frozen towers `loss_cfg` needs, with random weights from fixed
    seeds (`_tower_plan`), then the pretrained npz of `loss.weights_path`
    (LPIPS) and `loss.clip_weights_path` (CLIP) grafted over them where set,
    as medvae_tpu/train/trainer.py:196-233 does."""
    frozen = {}
    for key, (offset, loss) in _tower_plan(loss_cfg).items():
        frozen[key] = loss.init(seed + offset, device)
        path = loss_cfg.get("weights_path" if key == "lpips" else "clip_weights_path")
        if path:
            graft_npz(frozen[key], str(path), "LPIPS" if key == "lpips" else "CLIP")
    return frozen


def make_criterion(loss_cfg: Dict[str, Any], model) -> Callable:
    """criterion(frozen, outputs, targets) -> dict of fp32 scalar losses,
    for the `vae`, `disentangled_vae`, `lpips` and `biomedclip` loss types.
    The GAN type has its own step; its eval step without a discriminator
    falls back to the `vae` criterion, as in the JAX package."""
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

    if loss_type == "lpips":
        lp = LPIPSLoss(dtype=_tower_dtype(loss_cfg))

        def lpips_criterion(frozen, outputs, targets):
            loss = lp(frozen["lpips"], targets, outputs["reconstruction"])
            return {"loss": loss, "p_loss": loss}

        return lpips_criterion

    if loss_type == "biomedclip":
        bc = _clip_loss(loss_cfg)

        def clip_criterion(frozen, outputs, targets):
            loss = bc(frozen["clip"], targets, outputs["reconstruction"])
            return {"loss": loss, "bc_loss": loss}

        return clip_criterion

    if loss_type == "lpips_discriminator":
        return make_criterion({"type": "vae"}, model)
    raise ValueError(f"Unknown loss type: {loss_type}")


def make_gan_loss(loss_cfg: Dict[str, Any]) -> LPIPSWithDiscriminator:
    """The GAN loss of an `lpips_discriminator` config
    (medvae_tpu/train/step.py:253-271)."""
    return LPIPSWithDiscriminator(
        discriminator_factor=float(loss_cfg.get("discriminator_factor", 1.0)),
        perceptual_factor=float(loss_cfg.get("perceptual_factor", 1.0)),
        pixel_factor=float(loss_cfg.get("pixel_factor", 0.0)),
        kl_factor=float(loss_cfg.get("kl_factor", 1.0)),
        discriminator_iter_start=int(loss_cfg.get("discriminator_iter_start", 50001)),
        use_biomedclip_loss=bool(loss_cfg.get("use_biomedclip_loss", False)),
        biomedclip_factor=float(loss_cfg.get("biomedclip_factor", 1.0)),
        clip_encoder=str(loss_cfg.get("clip_encoder", "simple")),
        tower_dtype=_tower_dtype(loss_cfg),
    )


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


def make_decode_fn(model: torch.nn.Module) -> Callable:
    """decode(z, batch, generator) -> reconstruction; the flagship's decoder
    is routed by the batch's `modality_idx` (medvae_tpu/train/step.py:101-116)."""
    if isinstance(model, DisentangledConditionalVAE):
        return lambda z, batch, gen: model.decode(z, batch["modality_idx"], gen)
    return lambda z, batch, gen: model.decode(z, gen)


def prior_samples(model: torch.nn.Module, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """n prior samples decoded (NHWC): the flagship's by modality in turn
    (medvae_tpu/cli/evaluate.py:198-208, train/trainer.py:1108-1126); the
    ConditionalVAE's decoder is unconditional, so the plain prior sample
    covers it as Base and Beta."""
    if isinstance(model, DisentangledConditionalVAE):
        midx = torch.arange(n, device=model.heads_conv1.weight.device) % model.num_modalities
        return model.sample_conditional(n, midx, generator=generator)
    return model.sample(n, generator=generator)


def _grads_or_zeros(loss: torch.Tensor, params) -> list:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def build_loss_and_grads(
    model: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    *,
    augment: bool = False,
    max_channels: int = 3,
    normalize: bool = True,
):
    """`loss_and_grads(state, batch, generator=None, draws=None) ->
    (loss_dict, grads)`: the train step up to the gradients of the loss with
    respect to `state.params`, in their order (zeros for a param the loss
    does not reach, as jax.grad gives)."""
    grads_of = _loss_and_grads_of(model, loss_cfg)
    compute_dtype = model.dtype

    def loss_and_grads(
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ):
        x = preprocess(
            batch, generator, augment=augment, max_channels=max_channels,
            dtype=compute_dtype, draws=draws, normalize=normalize,
        )
        return grads_of(state, x, batch, generator)

    return loss_and_grads


def _loss_and_grads_of(model: torch.nn.Module, loss_cfg: Dict[str, Any]) -> Callable:
    """(state, x, batch, generator) -> (loss_dict, grads) on a preprocessed x."""
    criterion = make_criterion(loss_cfg, model)
    forward = make_forward_fn(model)

    def grads_of(state: TrainState, x: torch.Tensor, batch, generator):
        outputs = forward(x, batch, generator)
        loss_dict = criterion(state.frozen, outputs, x)
        grads = _grads_or_zeros(loss_dict["loss"], list(state.params.values()))
        return {k: v.detach() for k, v in loss_dict.items()}, grads

    return grads_of


def _gan_grads_of(model: torch.nn.Module, disc: torch.nn.Module, loss_cfg: Dict[str, Any]) -> Callable:
    """(state, x, batch, generator, d_valid) -> (g_grads, d_grads, logs):
    steps (1)-(5) of the GAN step on a preprocessed x (module docstring)."""
    gan_loss = make_gan_loss(loss_cfg)
    forward = make_forward_fn(model)
    decode = make_decode_fn(model)
    conv_out = model.decoder.conv_out.weight
    redecode = any(m.dropout for m in model.decoder.modules() if isinstance(m, ResnetBlock))

    def gan_grads(state: TrainState, x: torch.Tensor, batch, generator, d_valid: torch.Tensor):
        outputs = forward(x, batch, generator)
        recon = outputs["reconstruction"]
        kl = gaussian_kl(outputs["mean"], outputs["logvar"])
        kl_per_sample = kl.reshape(kl.shape[0], -1).sum(dim=1)
        logits_fake = disc(discriminator_input(recon), train=False)

        rec_a, logits_a = recon, logits_fake
        if redecode:  # a decoder pass on the detached z without dropout
            model.decoder.eval()
            try:
                rec_a = decode(outputs["z"].detach(), batch, generator)
            finally:
                model.decoder.train()
            logits_a = disc(discriminator_input(rec_a), train=False)
        nll = gan_loss.rec_for_adaptive(state.frozen, x, rec_a)
        (nll_grad,) = torch.autograd.grad(nll, conv_out, retain_graph=True)
        (g_grad,) = torch.autograd.grad(-logits_a.float().mean(), conv_out, retain_graph=True)
        d_weight = adaptive_weight([nll_grad], [g_grad])

        loss, g_log = gan_loss.generator_loss(state.frozen, x, recon, kl_per_sample, logits_fake,
                                              d_weight, d_valid)
        g_grads = _grads_or_zeros(loss, list(state.params.values()))

        recon = recon.detach()
        logits_real = disc(discriminator_input(x), train=True)
        logits_fake = disc(discriminator_input(recon), train=True)
        d_loss, d_log = gan_loss.discriminator_loss(logits_real, logits_fake, d_valid)
        d_grads = _grads_or_zeros(d_loss, list(state.disc_params.values()))
        return g_grads, d_grads, {**g_log, **d_log}

    return gan_grads


def build_gan_grads(
    model: torch.nn.Module,
    disc: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    *,
    augment: bool = False,
    max_channels: int = 3,
    normalize: bool = True,
):
    """`gan_grads(state, batch, generator=None, draws=None) -> (g_grads,
    d_grads, logs)`: steps (1)-(5) of the GAN step (module docstring), the
    generator's gradients in `state.params`' order and D's in
    `state.disc_params`' (medvae_tpu/train/step.py:make_gan_grads_fn). D's
    BatchNorm statistics are updated in place, twice."""
    gan_loss = make_gan_loss(loss_cfg)
    grads_of = _gan_grads_of(model, disc, loss_cfg)

    def gan_grads(
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ):
        x = preprocess(
            batch, generator, augment=augment, max_channels=max_channels,
            dtype=model.dtype, draws=draws, normalize=normalize,
        )
        d_valid = torch.tensor(gan_loss.d_valid(state.step), device=x.device)
        return grads_of(state, x, batch, generator, d_valid)

    return gan_grads


def _apply(params, updates, lr_scale: torch.Tensor) -> None:
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u * lr_scale)


def _ema(state: TrainState, ema_decay: float) -> None:
    if ema_decay and state.ema_params is not None:
        with torch.no_grad():
            for e, p in zip(state.ema_params.values(), state.params.values()):
                e.copy_(e * ema_decay + p * (1.0 - ema_decay))


def _microbatches(x: torch.Tensor, batch: Dict[str, torch.Tensor], k: int):
    """k (x, batch) slices of the leading axis; a batch k does not divide
    raises JAX's ValueError."""
    if x.shape[0] % k != 0:
        raise ValueError(f"batch size {x.shape[0]} not divisible by accumulate_grad_batches={k}")
    mb = x.shape[0] // k
    return [(x[i * mb:(i + 1) * mb], {n: t[i * mb:(i + 1) * mb] for n, t in batch.items()})
            for i in range(k)]


def _accumulate(total: Optional[list], part: list) -> list:
    """total + part, leaf by leaf in fp32, from zeros as JAX's scan carries."""
    if total is None:
        total = [torch.zeros_like(t, dtype=torch.float32) for t in part]
    for acc, t in zip(total, part):
        acc.add_(t)
    return total


class TrainStep:
    """`step(state, batch, generator=None, draws=None) -> (state, metrics)`,
    in three parts that a CUDA graph can split (train/multistep.py):

      * `prepare(state, generator)`, on the host: fills the step's 0-d
        device scalars (each optimizer's −lr and bias corrections,
        `lr_scale`, the GAN's d_valid) and seeds the microbatch generators;
      * `run(state, batch, generator, draws) -> metrics`: the step's device
        work, reading nothing from the host; the params, moments, EMA and
        D's state are updated in place;
      * `finish(state) -> state`: the counts advanced.

    Calling the object runs the three; a captured chunk replays `run` and
    calls the other two around each replay, so both paths run this code.

    With `accumulate_grad_batches` k > 1 (medvae_tpu/train/step.py:465-517,
    :555-): the batch, preprocessed whole, is split into k microbatches;
    their gradients (G's and D's on the GAN path, with D's BatchNorm
    statistics threaded through them in turn) and loss dicts are summed in
    fp32 and divided by k, then one update is applied. Microbatch i draws
    its noise and dropout from its own generator, seeded with
    `fold_in(generator.initial_seed(), i)`.

    With `nan_checks`, `run` reads back on the host whether any metric or
    gradient holds a NaN, before the update, and raises FloatingPointError
    naming the step and the first such tensor (metrics first, then the
    generator's gradients in param order, then D's); the read is a host
    sync, so a step with the checks is never captured.
    """

    def __init__(self, run_grads: Callable, optimizers: Callable, *, gan_loss=None, grad_norm: bool = False,
                 ema_decay: float = 0.0, accumulate_grad_batches: int = 1, augment: bool = False,
                 max_channels: int = 3, compute_dtype: torch.dtype = torch.float32, normalize: bool = True,
                 nan_checks: bool = False):
        self._run_grads = run_grads  # (state, x, batch, generator, d_valid) -> (grads by optimizer, logs)
        self._optimizers = optimizers  # state -> [(optimizer, its params, its state)]
        self.gan_loss = gan_loss
        self.grad_norm = grad_norm  # metrics["train/grad_norm"] of the (averaged) gradients
        self.ema_decay = ema_decay
        self.k = int(accumulate_grad_batches)
        self.augment, self.max_channels, self.compute_dtype = augment, max_channels, compute_dtype
        self.normalize, self.nan_checks = normalize, nan_checks
        self._scalars: Dict[str, torch.Tensor] = {}
        self._mb_generators: list = []

    def _scalar(self, name: str, device) -> torch.Tensor:
        if name not in self._scalars:
            self._scalars[name] = torch.zeros((), dtype=torch.float32, device=device)
        return self._scalars[name]

    def microbatch_generators(self, generator: Optional[torch.Generator]) -> list:
        """The k microbatch generators on `generator`'s device (none when
        k is 1 or there is no generator)."""
        if self.k <= 1 or generator is None:
            return []
        if not self._mb_generators:
            self._mb_generators = [torch.Generator(device=generator.device) for _ in range(self.k)]
        return self._mb_generators

    def prepare(self, state: TrainState, generator: Optional[torch.Generator] = None) -> None:
        device = next(iter(state.params.values())).device
        for tx, _, opt_state in self._optimizers(state):
            tx.prepare(opt_state)
        self._scalar("lr_scale", device).fill_(float(state.lr_scale))
        if self.gan_loss is not None:
            self._scalar("d_valid", device).fill_(self.gan_loss.d_valid(state.step))
        for i, gen in enumerate(self.microbatch_generators(generator)):
            gen.manual_seed(fold_in(generator.initial_seed(), i))

    def run(self, state: TrainState, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        x = preprocess(batch, generator, augment=self.augment, max_channels=self.max_channels,
                       dtype=self.compute_dtype, draws=draws, normalize=self.normalize)
        d_valid = self._scalars.get("d_valid")
        if self.k <= 1:
            grads, logs = self._run_grads(state, x, batch, generator, d_valid)
        else:
            gens = self.microbatch_generators(generator) or [None] * self.k
            grads = logs = None
            for (x_i, batch_i), gen in zip(_microbatches(x, batch, self.k), gens):
                g_i, logs_i = self._run_grads(state, x_i, batch_i, gen, d_valid)
                grads = [_accumulate(None if grads is None else grads[j], g) for j, g in enumerate(g_i)]
                names = list(logs_i)
                summed = _accumulate(None if logs is None else [logs[n] for n in names],
                                     [logs_i[n] for n in names])
                logs = dict(zip(names, summed))
            grads = [[g / self.k for g in part] for part in grads]
            logs = {n: v / self.k for n, v in logs.items()}
        if self.grad_norm:
            logs["train/grad_norm"] = global_norm(grads[0])
        if self.nan_checks:
            self._raise_on_nan(state, grads, logs)
        lr_scale = self._scalars["lr_scale"]
        updates = [tx.apply(g, opt_state, params)
                   for (tx, params, opt_state), g in zip(self._optimizers(state), grads)]
        for (_, params, _), u in zip(self._optimizers(state), updates):
            _apply(params, u, lr_scale)
        _ema(state, self.ema_decay)
        return logs

    def _raise_on_nan(self, state: TrainState, grads: list, logs: Dict[str, torch.Tensor]) -> None:
        names = [f"metric {k}" for k in logs]
        tensors = list(logs.values())
        groups = [("param", state.params)]
        if self.gan_loss is not None:
            groups.append(("discriminator param", state.disc_params))
        for (kind, params), part in zip(groups, grads):
            names += [f"the gradient of {kind} {n}" for n in params]
            tensors += list(part)
        flags = torch.stack([torch.isnan(t).any() for t in tensors]).cpu()
        if bool(flags.any()):
            first = int(flags.nonzero()[0])
            raise FloatingPointError(f"debug.nan_checks: NaN in {names[first]} at train step {state.step} "
                                     f"(after {state.step} optimizer updates)")

    def finish(self, state: TrainState) -> TrainState:
        for _, _, opt_state in self._optimizers(state):
            opt_state.count += 1
        return dataclasses.replace(state, step=state.step + 1)

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        self.prepare(state, generator)
        metrics = self.run(state, batch, generator, draws)
        return self.finish(state), metrics


def build_train_step(
    model: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    tx: Optimizer,
    *,
    augment: bool = False,
    max_channels: int = 3,
    ema_decay: float = 0.0,
    accumulate_grad_batches: int = 1,
    disc: Optional[torch.nn.Module] = None,
    disc_tx: Optional[Optimizer] = None,
    normalize: bool = True,
    nan_checks: bool = False,
) -> TrainStep:
    """The standard single-optimizer train step, or with `disc` and
    `disc_tx` the GAN step; see the module docstring and `TrainStep`."""
    common = dict(ema_decay=ema_decay, accumulate_grad_batches=accumulate_grad_batches,
                  augment=augment, max_channels=max_channels, compute_dtype=model.dtype,
                  normalize=normalize, nan_checks=nan_checks)
    if str(loss_cfg.get("type", "vae")) == "lpips_discriminator":
        if disc is None or disc_tx is None:
            raise ValueError("the lpips_discriminator loss trains with a discriminator and its "
                             "optimizer: pass disc= and disc_tx=")
        gan_grads = _gan_grads_of(model, disc, loss_cfg)

        def run_gan(state, x, batch, generator, d_valid):
            g_grads, d_grads, logs = gan_grads(state, x, batch, generator, d_valid)
            return (g_grads, d_grads), logs

        def gan_optimizers(state):
            return [(tx, list(state.params.values()), state.opt_state),
                    (disc_tx, list(state.disc_params.values()), state.disc_opt_state)]

        return TrainStep(run_gan, gan_optimizers, gan_loss=make_gan_loss(loss_cfg), **common)
    grads_of = _loss_and_grads_of(model, loss_cfg)

    def run_plain(state, x, batch, generator, d_valid):
        loss_dict, grads = grads_of(state, x, batch, generator)
        metrics = {f"train/{k}": v for k, v in loss_dict.items()}
        return (grads,), metrics

    def optimizers(state):
        return [(tx, list(state.params.values()), state.opt_state)]

    return TrainStep(run_plain, optimizers, grad_norm=True, **common)


def build_eval_step(
    model: torch.nn.Module,
    loss_cfg: Dict[str, Any],
    *,
    max_channels: int = 3,
    n_modalities: int = 0,
    disc: Optional[torch.nn.Module] = None,
    normalize: bool = True,
):
    """The eval step; see the module docstring. The per-modality sums are
    `max(n_modalities, 12, model.num_modalities)` wide. With the GAN loss
    and `disc`, the loss terms are the GAN's (medvae_tpu/train/step.py:724-752):
    `val/loss` and the generator's terms with d_weight 0, and D in eval mode
    on the reconstruction and on x for `val/d_loss` and the logits."""
    gan_loss = None
    if str(loss_cfg.get("type", "vae")) == "lpips_discriminator" and disc is not None:
        gan_loss = make_gan_loss(loss_cfg)
    criterion = make_criterion(loss_cfg, model)

    d_valid: Dict[Any, torch.Tensor] = {}  # the GAN gate's 0-d tensor by device, filled by prepare

    def prepare(state: TrainState) -> None:
        if gan_loss is not None:
            device = next(iter(state.params.values())).device
            if device not in d_valid:
                d_valid[device] = torch.zeros((), dtype=torch.float32, device=device)
            d_valid[device].fill_(gan_loss.d_valid(state.step))

    def gan_terms(state, outputs, x):
        recon = outputs["reconstruction"]
        kl = gaussian_kl(outputs["mean"], outputs["logvar"])
        logits_fake = disc(discriminator_input(recon), train=False)
        loss, g_log = gan_loss.generator_loss(
            state.frozen, x, recon, kl.reshape(kl.shape[0], -1).sum(dim=1), logits_fake,
            torch.zeros((), device=x.device), d_valid[x.device], split="val")
        logits_real = disc(discriminator_input(x), train=False)
        _, d_log = gan_loss.discriminator_loss(logits_real, logits_fake, d_valid[x.device], split="val")
        return {"loss": loss, **{k.split("/", 1)[1]: v for k, v in {**g_log, **d_log}.items()}}
    forward = make_forward_fn(model)
    n_mod = max(n_modalities, len(MODALITY_NAMES), int(getattr(model, "num_modalities", 0) or 0))

    @torch.no_grad()
    def run(
        state: TrainState, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            x = preprocess(batch, None, augment=False, max_channels=max_channels, dtype=model.dtype,
                           normalize=normalize)
            outputs = forward(x, batch, generator)
        finally:
            model.train(was_training)
        valid = batch.get("valid")
        terms = (gan_terms(state, outputs, x) if gan_loss is not None
                 else criterion(state.frozen, outputs, x))
        metrics = {f"val/{k}": v for k, v in terms.items()}
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

    def eval_step(
        state: TrainState, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        prepare(state)
        return run(state, batch, generator)

    # the host part and the device part apart, for a captured eval
    # (train/multistep.py:build_eval_chunk_runner)
    eval_step.prepare, eval_step.run = prepare, run
    return eval_step
