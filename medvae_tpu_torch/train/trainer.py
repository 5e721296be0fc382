"""Training orchestration (counterpart of medvae_tpu/train/trainer.py).

`Trainer(cfg)` takes a composed config (config/compose.py) and owns the run:
the seed, the datamodule, the model (`build_model(..., train=True)` with
`init_weights` from the seed), the optimizer and schedule with the epoch's
step count, the train and eval steps, checkpoints, early stopping,
ReduceLROnPlateau and the metric logger. `fit()` trains with per-epoch (or
mid-epoch, `val_check_interval`) validation and returns the last validation
metrics; `test()` evaluates the test split. The step math lives in
train/step.py; this file is control flow only.

Exact resume: `resume=true` restores `last` (or `resume_from=<dir>`), and
`fit` continues at its optimizer step, skipping the batches of the partial
epoch it already took. The feeder's order is a function of (seed, epoch) and
every step's generator is re-seeded from (seed, step), so a resumed run
trains on the CPU bit for bit as the uninterrupted one does.

The GAN loss (`lpips_discriminator`) adds the PatchGAN of
`training.discriminator` (seeded from seed + 7; a config whose image size
leaves it an empty logit map raises ValueError), its optimizer
(`discriminator_optimizer`) and its state; the train and eval steps take it,
and checkpoints carry it.

`device: cpu` runs on the CPU; `tpu`, `cuda` and `gpu` mean the card, and
raise without one. Not ported yet, each raising NotImplementedError:
`data.device_cache: true`, `training.fused_steps: on`, `data.batch_size:
auto`, an explicit `model.remat` rung, a mesh of more than one device,
`parallel.explicit_shard_map`, `debug.profile`, `debug.nan_checks` and
`data.normalize: false`. The defaults the JAX package resolves on the
TPU are resolved here, each said once: `remat: auto` to no remat (the H100
holds the 128² BaseVAE at bs 64 without it), `device_cache: auto` to the host
feeder, `fused_steps: auto` to one step a call.

Media: every `log_images_every_n_epochs` epochs (10 by default, epoch 0
included), after the epoch's steps, `_log_media` writes
`<run_dir>/media/epoch_XXXX_recon.png` (eight validation images over their
reconstructions) and `epoch_XXXX_samples.png` (16 prior samples, the
flagship's by modality in turn) through utils/visualization.py, drawn from
a generator seeded by (seed, epoch), so training draws are untouched.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from medvae_tpu_torch.config.instantiate import instantiate
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.core.rng import fold_in, set_seed
from medvae_tpu_torch.data.modalities import MODALITY_NAMES
from medvae_tpu_torch.data.pipeline import DeviceFeeder, preprocess
from medvae_tpu_torch.nn.discriminator import build_discriminator, logit_size
from medvae_tpu_torch.train.checkpoint import CheckpointManager
from medvae_tpu_torch.train.metrics import to_host
from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
from medvae_tpu_torch.train.state import create_train_state
from medvae_tpu_torch.train.step import (build_eval_step, build_train_step, make_forward_fn, make_frozen,
                                         prior_samples)
from medvae_tpu_torch.utils.logging import MetricLogger
from medvae_tpu_torch.utils.training_utils import EarlyStopping

_TRAIN_STREAM, _EVAL_STREAM, _MEDIA_STREAM = 0xBEEF, 0xE7A1, 0x3ED1A


def resolve_device(name: Any) -> torch.device:
    """`cpu`, or the card for `tpu`, `cuda` and `gpu` (the JAX configs say
    `tpu`); raises when the card is asked for and there is none."""
    name = str(name).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("tpu", "cuda", "gpu"):
        raise ValueError(f"device {name!r}: expected cpu, cuda, gpu or tpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={name} asks for the card and there is no CUDA device; "
                           "pass device=cpu to train on the CPU")
    return torch.device("cuda")


def _reject_unported(cfg) -> None:
    """Fail at start, naming the option, on what the port does not do yet."""
    data, tcfg, model = cfg.get("data") or {}, cfg.get("training") or {}, cfg.get("model") or {}
    mesh, debug = cfg.get("mesh") or {}, cfg.get("debug") or {}
    unported = {
        "data.device_cache": str(data.get("device_cache", "auto")).lower() in ("true", "1", "on"),
        "training.fused_steps": str(tcfg.get("fused_steps", "auto")).lower() in ("true", "1", "on"),
        "data.batch_size=auto": str(data.get("batch_size", "")).lower() == "auto",
        "data.normalize=false": not data.get("normalize", True),
        "model.remat": str(model.get("remat", "auto")).lower() not in ("auto", "false", "0", "none"),
        "a mesh of more than one device": int(mesh.get("data", -1)) > 1 or int(mesh.get("model", 1)) > 1,
        "parallel.explicit_shard_map": bool((cfg.get("parallel") or {}).get("explicit_shard_map")),
        "debug.profile": bool(debug.get("profile")),
        "debug.nan_checks": bool(debug.get("nan_checks")),
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"not ported to the PyTorch package yet: {', '.join(asked)}")


def decoded_size(size: int, n_down: int) -> int:
    """The side a size×size input leaves the decoder with: each stride-2
    downsample after the (0, 1, 0, 1) pad floors, each upsample doubles."""
    for _ in range(n_down):
        size //= 2
    return size * 2**n_down


class Trainer:
    def __init__(self, cfg):
        self.cfg = cfg
        _reject_unported(cfg)
        self.seed = int(cfg.get("seed", 42))
        set_seed(self.seed)
        self.device = resolve_device(cfg.get("device", "tpu"))

        self.datamodule = instantiate(dict(cfg["data"]))
        self.datamodule.setup(None)

        self.model_cfg = {k: v for k, v in dict(cfg["model"]).items() if k != "remat"}
        high_res = int(self.model_cfg.get("resolution", 28)) >= 112
        if str(cfg["model"].get("remat", "auto" if high_res else False)).lower() == "auto":
            print("remat=auto: no remat (the JAX package probes a rung on the TPU; "
                  "the port trains without one)")
        self.precision = str(cfg.get("precision", "bf16"))
        self.model = build_model(self.model_cfg, self.precision, self.device, train=True)
        init_weights(self.model, seed=self.seed)
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"Model: {type(self.model).__name__}  ({n_params:,} parameters)")
        self._validate_geometry()

        tcfg = cfg["training"]
        self.loss_cfg = dict(tcfg.get("loss", {"type": "vae"}))
        if "discriminator" in tcfg:
            self.loss_cfg.setdefault("discriminator", dict(tcfg["discriminator"]))
        frozen = make_frozen(self.loss_cfg, self.device, seed=self.seed)
        bs = int(self.datamodule.batch_size)
        self.steps_per_epoch = max(1, len(self.datamodule.train_arrays) // bs)
        opt_args = (dict(tcfg.get("optimizer", {})), dict(tcfg.get("scheduler", {}) or {}))
        opt_kwargs = dict(steps_per_epoch=self.steps_per_epoch,
                          gradient_clip_val=tcfg.get("gradient_clip_val", 1.0))
        self.tx = build_optimizer(*opt_args, **opt_kwargs)
        self.disc = disc_tx = None
        if str(self.loss_cfg.get("type")) == "lpips_discriminator":
            self.disc = build_discriminator(self.loss_cfg.get("discriminator"), self.device,
                                            seed=self.seed + 7)
            side = logit_size(int(self.datamodule.size), self.disc.n_layers)
            if side <= 0:
                raise ValueError(
                    f"Discriminator emits an empty logit map (1, {side}, {side}, 1) at image size "
                    f"{self.datamodule.size}; reduce n_layers or increase the image size")
            disc_tx = discriminator_optimizer(*opt_args, **opt_kwargs)
        ema_decay = float(tcfg.get("ema_decay", 0.0) or 0.0)
        self.state = create_train_state(self.model, self.tx, frozen, ema_decay=ema_decay,
                                        disc=self.disc, disc_tx=disc_tx)

        # ReduceLROnPlateau (reference training_utils.py:49-55): host-driven
        # lr_scale on a stagnating monitored metric
        sched_cfg = dict(tcfg.get("scheduler", {}) or {})
        self._plateau = None
        if str(sched_cfg.get("type", "")).lower() == "plateau":
            self._plateau = {
                "factor": float(sched_cfg.get("factor", 0.1)),
                "patience": int(sched_cfg.get("patience", 10)),
                "monitor": str(sched_cfg.get("monitor", "val/loss")),
                "best": None,
                "count": 0,
            }
        self._monitors_checked = False

        dm = self.datamodule
        self.train_step = build_train_step(
            self.model, self.loss_cfg, self.tx, augment=bool(dm.augment_train),
            max_channels=dm.max_channels, ema_decay=ema_decay,
            accumulate_grad_batches=int(tcfg.get("accumulate_grad_batches", 1) or 1),
            disc=self.disc, disc_tx=disc_tx,
        )
        self.eval_step = build_eval_step(self.model, self.loss_cfg, max_channels=dm.max_channels,
                                         disc=self.disc)
        self._feeders: Dict[Any, DeviceFeeder] = {}
        self._generator = torch.Generator(device=self.device)

        ckpt_cfg = cfg.get("checkpointing", {}) or {}
        ckpt_dir = os.path.join(cfg.get("checkpoint_dir", "logs/checkpoints"),
                                cfg.get("experiment_name", "run"))
        self.ckpt = CheckpointManager(
            ckpt_dir, self.model_cfg, self.precision,
            save_top_k=int(ckpt_cfg.get("save_top_k", 3)),
            monitor=ckpt_cfg.get("monitor", "val/loss"),
            mode=ckpt_cfg.get("mode", "min"),
            save_last=bool(ckpt_cfg.get("save_last", True)),
        )
        # the composed config beside the checkpoints, so a later tool can
        # rebuild the run without the original command line
        from medvae_tpu_torch.config.compose import save_yaml

        save_yaml(cfg, os.path.join(ckpt_dir, "config.yaml"))
        es_cfg = cfg.get("early_stopping", {}) or {}
        self.early_stopping = (
            EarlyStopping(patience=int(es_cfg.get("patience", 20)), mode=es_cfg.get("mode", "min"),
                          monitor=es_cfg.get("monitor", "val/loss"))
            if es_cfg.get("enabled", False) else None
        )
        self.logger = MetricLogger(cfg.get("log_dir", "logs"), cfg.get("experiment_name", "run"),
                                   config=cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
                                   wandb_cfg=cfg.get("wandb"))

        resume_from = cfg.get("resume_from") or ("last" if cfg.get("resume") else None)
        if resume_from:
            target = resume_from if os.path.isabs(str(resume_from)) else os.path.join(ckpt_dir, str(resume_from))
            if os.path.isdir(target):
                self.state = self.ckpt.restore(self.state, target)
                self._load_monitor_state()
                print(f"Resumed from {target} at step {self.state.step}")
            else:
                print(f"resume requested but no checkpoint at {target}; fresh start")

    # ------------------------------------------------------------------ #

    def _validate_geometry(self) -> None:
        """Fail at start when the codec cannot give back the input size
        (the JAX trainer's check, by arithmetic instead of shape inference)."""
        size = int(self.datamodule.size)
        n_down = len(tuple(self.model.ch_mult)) - 1
        out = decoded_size(size, n_down)
        if out != size:
            raise ValueError(
                f"model/data geometry mismatch: {size}x{size} inputs come out of the decoder "
                f"as {out}x{out} reconstructions ({n_down} stride-2 downsamples floor odd "
                f"sizes; upsampling doubles). Use a ch_mult with fewer levels (e.g. [1,2,4] "
                f"for 28x28) or a data.size divisible by 2^{n_down}."
            )

    def _save_monitor_state(self) -> None:
        blob: Dict[str, Any] = {}
        if self._plateau is not None:
            blob["plateau"] = {"best": self._plateau["best"], "count": self._plateau["count"]}
        if self.early_stopping is not None:
            blob["early_stopping"] = {"best": self.early_stopping.best,
                                      "counter": self.early_stopping.counter}
        if blob:
            with open(os.path.join(self.ckpt.directory, "trainer_state.json"), "w") as f:
                json.dump(blob, f)

    def _load_monitor_state(self) -> None:
        path = os.path.join(self.ckpt.directory, "trainer_state.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            blob = json.load(f)
        p = blob.get("plateau")
        if p and self._plateau is not None:
            self._plateau["best"] = p.get("best")
            self._plateau["count"] = int(p.get("count", 0))
        es = blob.get("early_stopping")
        if es and self.early_stopping is not None:
            self.early_stopping.best = es.get("best")
            self.early_stopping.counter = int(es.get("counter", 0))

    def _feeder(self, split: str, shuffle: bool, drop_last: bool) -> DeviceFeeder:
        """One feeder per (split, shuffle, drop_last), over the host arrays
        (`data.device_cache: auto` resolves to this path in the port)."""
        key = (split, shuffle, drop_last)
        if key not in self._feeders:
            if not self._feeders and str((self.cfg.get("data") or {}).get("device_cache", "auto")).lower() == "auto":
                print("device_cache=auto: batches stream from host memory (the device-cached "
                      "feeder is not ported)")
            stratify = shuffle and bool((self.cfg.get("data") or {}).get("stratify_batches", False))
            self._feeders[key] = DeviceFeeder(
                self.datamodule.split(split), self.datamodule.batch_size, self.device,
                shuffle=shuffle, drop_last=drop_last, seed=self.seed, stratify=stratify,
            )
        return self._feeders[key]

    def _seeded(self, stream: int, step: int) -> torch.Generator:
        return self._generator.manual_seed(fold_in(self.seed, stream, step))

    def validate(self, split: str = "val") -> Dict[str, float]:
        """Whole-split metrics: each batch's masked means weighted by its
        valid count, per-modality PSNR, and for the flagship the exact
        whole-split centroid distance of z_modality."""
        feeder = self._feeder(split, shuffle=False, drop_last=False)
        gen = self._seeded(_EVAL_STREAM, self.state.step)
        acc: Dict[str, float] = {}
        weight_total = 0.0
        psnr_by_mod = count_by_mod = zmod_sum = None
        for batch in feeder.epoch(0):
            host = to_host(self.eval_step(self.state, batch, gen))
            w = float(host.pop("val/_weight"))
            p_mod, c_mod = host.pop("val/_psnr_by_mod"), host.pop("val/_count_by_mod")
            zs = host.pop("val/_zmod_sum_by_mod", None)
            psnr_by_mod = p_mod if psnr_by_mod is None else psnr_by_mod + p_mod
            count_by_mod = c_mod if count_by_mod is None else count_by_mod + c_mod
            if zs is not None:
                zmod_sum = zs if zmod_sum is None else zmod_sum + zs
            weight_total += w
            for k, v in host.items():
                acc[k] = acc.get(k, 0.0) + float(v) * w
        out = {k: v / max(weight_total, 1.0) for k, v in acc.items()}
        if zmod_sum is not None:
            present = count_by_mod > 0
            if int(present.sum()) >= 2:
                cents = zmod_sum[present] / count_by_mod[present, None]
                d = np.sqrt(((cents[:, None, :] - cents[None, :, :]) ** 2).sum(-1))
                out["val/centroid_distance"] = float(d[np.triu_indices(len(cents), 1)].mean())
        for mod in range(0 if psnr_by_mod is None else len(psnr_by_mod)):
            if count_by_mod[mod] > 0:
                name = MODALITY_NAMES[mod] if mod < len(MODALITY_NAMES) else f"mod{mod}"
                out[f"val/psnr_{name}"] = float(psnr_by_mod[mod] / count_by_mod[mod])
        if split != "val":
            out = {k.replace("val/", f"{split}/", 1): v for k, v in out.items()}
        return out

    def fit(self) -> Dict[str, float]:
        tcfg = self.cfg["training"]
        max_epochs = int(tcfg.get("max_epochs", 10))
        log_every = int(tcfg.get("log_every_n_steps", 50))
        val_interval = float(tcfg.get("val_check_interval", 1.0))
        check_every = int(tcfg.get("check_val_every_n_epoch", 1))
        limit_train = int(tcfg.get("limit_train_batches", 0)) or None
        media_every = int(tcfg.get("log_images_every_n_epochs", 10) or 0)
        if str(tcfg.get("fused_steps", "auto")).lower() == "auto":
            print("fused_steps=auto: one train step a call (fused chunks are not ported)")
        ckpt_every = int((self.cfg.get("checkpointing") or {}).get("every_n_steps", 0) or 0)

        feeder = self._feeder("train", shuffle=True, drop_last=True)
        banner = self.datamodule.synthetic_banner("training")
        if banner:
            print(banner)
        last_val: Dict[str, float] = {}
        mid_val_at = int(self.steps_per_epoch * val_interval) if 0 < val_interval < 1 else None
        # exact resume: continue at the restored optimizer step, skipping the
        # batches of the partial epoch the run already took
        eff_steps = min(self.steps_per_epoch, limit_train) if limit_train else self.steps_per_epoch
        start_epoch, skip_batches = divmod(self.state.step, eff_steps)
        if self.state.step:
            print(f"Resuming at optimizer step {self.state.step} -> epoch {start_epoch}, "
                  f"skipping {skip_batches} consumed batches")
        t_start, images_seen, first_timed = time.time(), 0, False
        try:
            for epoch in range(start_epoch, max_epochs):
                epoch_t0 = time.time()
                for i, batch in enumerate(feeder.epoch(epoch)):
                    if limit_train and i >= limit_train:
                        break
                    if epoch == start_epoch and i < skip_batches:
                        continue
                    gen = self._seeded(_TRAIN_STREAM, self.state.step)
                    self.state, metrics = self.train_step(self.state, batch, gen)
                    images_seen += self.datamodule.batch_size
                    step = epoch * self.steps_per_epoch + i + 1
                    if not first_timed:  # throughput leaves the first step out
                        first_timed, t_start, images_seen = True, time.time(), 0
                    if step % log_every == 0:
                        host = {k: float(v) for k, v in metrics.items()}
                        host["train/images_per_sec"] = images_seen / max(time.time() - t_start, 1e-9)
                        host["epoch"] = epoch
                        self.logger.log(host, step)
                        loss = host.get("train/loss", host.get("train/total_loss", float("nan")))
                        print(f"epoch {epoch} step {step} loss {loss:.4f} "
                              f"({host['train/images_per_sec']:.0f} img/s)")
                    if ckpt_every and step % ckpt_every == 0:
                        self.ckpt.save_step(self.state)  # refresh `last`
                    if mid_val_at and (i + 1) == mid_val_at:
                        last_val = self.validate()
                        self.logger.log(last_val, step)

                # the media cadence is independent of validation's
                # (medvae_tpu/train/trainer.py:1031-1035)
                if media_every and epoch % media_every == 0:
                    self._log_media(epoch, (epoch + 1) * self.steps_per_epoch)

                if (epoch + 1) % check_every == 0:
                    last_val = self.validate()
                    self._check_monitors(last_val)
                    step = (epoch + 1) * self.steps_per_epoch
                    last_val["epoch_time_sec"] = time.time() - epoch_t0
                    self.logger.log(last_val, step)
                    print(f"epoch {epoch} val/loss {last_val.get('val/loss', float('nan')):.4f} "
                          f"psnr {last_val.get('val/psnr', float('nan')):.2f}")
                    self.ckpt.save_step(self.state, last_val)
                    self._maybe_reduce_lr(last_val)
                    stop = bool(self.early_stopping and self.early_stopping.update(last_val))
                    self._save_monitor_state()
                    if stop:
                        print(f"Early stopping at epoch {epoch}")
                        break
        finally:
            self.logger.close()
        final = self.ckpt.save_final(self.state, self.cfg.get("experiment_name", "run"))
        print(f"Final checkpoint: {final}")
        return last_val

    @torch.no_grad()
    def _log_media(self, epoch: int, step: int) -> None:
        """The reconstruction and prior-sample grids of `epoch` into
        <run_dir>/media (medvae_tpu/train/trainer.py:1076-1150)."""
        from medvae_tpu_torch.utils.visualization import plot_reconstructions, plot_samples, to_unit

        media_dir = os.path.join(self.logger.dir, "media")
        batch = next(iter(self._feeder("val", shuffle=False, drop_last=False).epoch(0)))
        gen = self._seeded(_MEDIA_STREAM, epoch)
        was_training = self.model.training
        self.model.eval()
        try:
            x = preprocess(batch, None, augment=False, max_channels=self.datamodule.max_channels,
                           dtype=self.model.dtype)
            recon = make_forward_fn(self.model)(x, batch, gen)["reconstruction"]
            samples = prior_samples(self.model, 16, gen)
        finally:
            self.model.train(was_training)
        recon_path = os.path.join(media_dir, f"epoch_{epoch:04d}_recon.png")
        sample_path = os.path.join(media_dir, f"epoch_{epoch:04d}_samples.png")
        # each array rescaled as a whole, as the JAX Trainer does
        x, recon, samples = (to_unit(t.float().cpu().numpy()) for t in (x[:8], recon[:8], samples))
        plot_reconstructions(x, recon, save_path=recon_path)
        plot_samples(samples, save_path=sample_path, title=f"Prior samples — epoch {epoch}")
        self.logger.log_images({"media/reconstructions": recon_path, "media/samples": sample_path}, step)

    def _check_monitors(self, val_metrics: Dict[str, float]) -> None:
        """Fail on a monitor key validation never emits (once, at the first
        validation), instead of never checkpointing or stopping."""
        if self._monitors_checked:
            return
        self._monitors_checked = True
        wanted = {"checkpointing.monitor": self.ckpt.monitor}
        if self.early_stopping is not None:
            wanted["early_stopping.monitor"] = self.early_stopping.monitor
        if self._plateau is not None:
            wanted["scheduler.monitor (plateau)"] = self._plateau["monitor"]
        missing = {n: k for n, k in wanted.items() if k not in val_metrics}
        if missing:
            raise ValueError(f"Monitored metric(s) not produced by validation: {missing}. "
                             f"Available keys: {sorted(val_metrics)}")

    def _maybe_reduce_lr(self, val_metrics: Dict[str, float]) -> None:
        if self._plateau is None:
            return
        value = val_metrics.get(self._plateau["monitor"])
        if value is None:
            return
        p = self._plateau
        if p["best"] is None or value < p["best"] - 1e-8:
            p["best"], p["count"] = value, 0
            return
        p["count"] += 1
        if p["count"] >= p["patience"]:
            p["count"] = 0
            self.state.lr_scale *= p["factor"]
            print(f"ReduceLROnPlateau: lr_scale -> {self.state.lr_scale:.2e}")

    def test(self) -> Dict[str, float]:
        self.datamodule.setup("test")
        return self.validate("test")
