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
raise without one. Not ported yet, each raising NotImplementedError: a mesh
of more than one device and `parallel.explicit_shard_map`.

Options (medvae_tpu/train/trainer.py:509-510, 861-936, 1021-1023,
1058-1059):
  * `data.normalize: false` leaves images in [0, 1] in the train and eval
    steps (fused chunks included: their step preprocesses) and the media
    grids;
  * `debug.nan_checks`: every train step reads back whether its metrics or
    gradients hold a NaN and raises FloatingPointError on the first, naming
    the step and the tensor (train/step.py:TrainStep); a validation whose
    metrics hold one raises too. Fused chunks are off under it, so each step
    is checked before its update;
  * `debug.profile`: torch.profiler (the CPU, and the card's kernels on the
    card) over the steps [start, min(20, steps_per_epoch)), its window
    padded PROFILE_PAD_S at each end, written as a Chrome trace to
    `<run_dir>/profile/trace.json`; fused chunks are off under it, as in JAX.

The speed paths resolve as the JAX Trainer's do, each said once:
  * `data.device_cache: auto|true|false`: a split is pinned on the device
    (`DeviceCachedFeeder`, JAX's device-cached batch order) when forced, or
    under auto when its uint8 arrays fit `MEDVAE_DEVICE_CACHE_BUDGET` (2 GiB);
    else the host feeder streams it;
  * `training.fused_steps: auto|on|off`: on a cached train split, chunks of
    steps replay one captured CUDA graph (train/multistep.py; on the CPU the
    same loop), under auto when the run plans at least
    `FUSED_AUTO_MIN_STEPS` (`MEDVAE_FUSED_MIN_STEPS`, 200) steps; chunks end
    at every log, checkpoint and mid-epoch validation step, and a resumed
    run starts mid-plan at its step. Validation of a cached split replays
    one captured eval step when fused;
  * `data.batch_size: auto`: the largest batch the production step takes
    on the card (train/autobatch.py; `training.autobatch_start`,
    `autobatch_max`, `autobatch_probes`);
  * `model.remat: false|block|conv|full|auto` (auto is the default at 112²
    and above): auto probes the rungs on the card with the production step
    (train/autoremat.py) and records the decision in the checkpoint
    directory's trainer_state.json, which a resumed run reuses; under
    `batch_size: auto`, and off the card, auto takes "full" unprobed;
  * `training.accumulate_grad_batches` k > 1 splits each batch into k
    microbatches (train/step.py:TrainStep); the disentangled loss refuses it
    unless `training.allow_microbatched_disentangled`, as in JAX.

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
from typing import Any, Dict, Optional

import numpy as np
import torch

from medvae_tpu_torch.config.instantiate import instantiate
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.core.rng import fold_in, set_seed
from medvae_tpu_torch.data.modalities import MODALITY_NAMES
from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder, DeviceFeeder, preprocess, split_cache_nbytes
from medvae_tpu_torch.nn.discriminator import build_discriminator, logit_size
from medvae_tpu_torch.nn.encoder_decoder import remat_rung, set_remat
from medvae_tpu_torch.train.checkpoint import CheckpointManager
from medvae_tpu_torch.train.metrics import to_host
from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
from medvae_tpu_torch.train.state import create_train_state
from medvae_tpu_torch.train.step import (build_eval_step, build_train_step, make_forward_fn, make_frozen,
                                         prior_samples)
from medvae_tpu_torch.utils.logging import MetricLogger
from medvae_tpu_torch.utils.training_utils import EarlyStopping

_TRAIN_STREAM, _EVAL_STREAM, _MEDIA_STREAM, _PROBE_STREAM = 0xBEEF, 0xE7A1, 0x3ED1A, 0x9E0B

# fused_steps=auto fuses only when the run plans at least this many steps
# (medvae_tpu/train/trainer.py:47); each chunk runner captures one graph
FUSED_AUTO_MIN_STEPS = int(os.environ.get("MEDVAE_FUSED_MIN_STEPS", 200))
# debug.profile's host sleep after the window opens and before it closes:
# Kineto keeps a kernel only inside its window on the host's clock, and drops
# those launched at its very edge (chip_smoke.py:TRACE_PAD_S)
PROFILE_PAD_S = 0.025


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
    mesh = cfg.get("mesh") or {}
    unported = {
        "a mesh of more than one device": int(mesh.get("data", -1)) > 1 or int(mesh.get("model", 1)) > 1,
        "parallel.explicit_shard_map": bool((cfg.get("parallel") or {}).get("explicit_shard_map")),
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

        data_cfg = dict(cfg["data"])
        # data.batch_size=auto: probed below with the production step; the
        # datamodule is built with a placeholder that the probe overwrites
        self._auto_bs = str(data_cfg.get("batch_size", "")).lower() == "auto"
        if self._auto_bs:
            data_cfg["batch_size"] = 64
        self.datamodule = instantiate(data_cfg)
        self.datamodule.setup(None)
        self.normalize = bool(getattr(self.datamodule, "normalize", True))

        self.model_cfg = {k: v for k, v in dict(cfg["model"]).items() if k != "remat"}
        high_res = int(self.model_cfg.get("resolution", 28)) >= 112
        remat_req = cfg["model"].get("remat", "auto" if high_res else False)
        self._auto_remat = str(remat_req).lower() == "auto"
        self._resolved_remat = None  # the rung remat=auto chose, recorded with the checkpoints
        self._drop_device_cache = False
        self.precision = str(cfg.get("precision", "bf16"))
        self.model = build_model(self.model_cfg, self.precision, self.device, train=True)
        init_weights(self.model, seed=self.seed)
        # remat=auto builds at the safe "full" rung until the probe below
        set_remat(self.model, "full" if self._auto_remat else remat_rung(remat_req))
        if not self._auto_remat:
            print(f"remat={remat_rung(remat_req)!r}")
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"Model: {type(self.model).__name__}  ({n_params:,} parameters)")
        self._validate_geometry()

        tcfg = cfg["training"]
        self.loss_cfg = dict(tcfg.get("loss", {"type": "vae"}))
        if "discriminator" in tcfg:
            self.loss_cfg.setdefault("discriminator", dict(tcfg["discriminator"]))
        accumulate = int(tcfg.get("accumulate_grad_batches", 1) or 1)
        if (str(self.loss_cfg.get("type")) == "disentangled_vae" and accumulate > 1
                and not bool(tcfg.get("allow_microbatched_disentangled", False))):
            mb = int(self.datamodule.batch_size) // max(accumulate, 1)
            raise ValueError(
                f"accumulate_grad_batches={accumulate} would compute the batch-global "
                f"separation/contrastive losses on {mb}-sample microbatches (batch "
                f"{self.datamodule.batch_size} is split, not multiplied). Use a full batch with "
                f"remat instead, or set +training.allow_microbatched_disentangled=true if the "
                f"microbatch size still covers every modality.")
        frozen = make_frozen(self.loss_cfg, self.device, seed=self.seed)
        self.disc = None
        if str(self.loss_cfg.get("type")) == "lpips_discriminator":
            self.disc = build_discriminator(self.loss_cfg.get("discriminator"), self.device,
                                            seed=self.seed + 7)
            side = logit_size(int(self.datamodule.size), self.disc.n_layers)
            if side <= 0:
                raise ValueError(
                    f"Discriminator emits an empty logit map (1, {side}, {side}, 1) at image size "
                    f"{self.datamodule.size}; reduce n_layers or increase the image size")
        ema_decay = float(tcfg.get("ema_decay", 0.0) or 0.0)
        dm = self.datamodule
        opt_args = (dict(tcfg.get("optimizer", {})), dict(tcfg.get("scheduler", {}) or {}))

        def make_step(steps_per_epoch: int):
            """(state, train step) at the datamodule's batch size."""
            opt_kwargs = dict(steps_per_epoch=steps_per_epoch,
                              gradient_clip_val=tcfg.get("gradient_clip_val", 1.0))
            tx = build_optimizer(*opt_args, **opt_kwargs)
            disc_tx = discriminator_optimizer(*opt_args, **opt_kwargs) if self.disc is not None else None
            state = create_train_state(self.model, tx, frozen, ema_decay=ema_decay, disc=self.disc,
                                       disc_tx=disc_tx)
            step = build_train_step(self.model, self.loss_cfg, tx, augment=bool(dm.augment_train),
                                    max_channels=dm.max_channels, ema_decay=ema_decay,
                                    accumulate_grad_batches=accumulate, disc=self.disc, disc_tx=disc_tx,
                                    normalize=self.normalize, nan_checks=self._debug("nan_checks"))
            return tx, state, step

        if self._auto_bs:
            from medvae_tpu_torch.train.autobatch import resolve_auto_batch_size

            if self._auto_remat:
                print("remat=auto: probing is skipped under batch_size=auto (the batch probe "
                      "maxes memory against the safe 'full' rung); effective remat='full'")
            _, probe_state, probe_step = make_step(1)
            dm.batch_size = resolve_auto_batch_size(
                probe_step, probe_state, dm, self.device,
                start=int(tcfg.get("autobatch_start", 64) or 64),
                max_batch=int(tcfg.get("autobatch_max", 65536) or 65536),
                max_probes=int(tcfg.get("autobatch_probes", 16) or 16),
                ballast_bytes=self._projected_cache_bytes(),
                captured=self.device.type == "cuda" and self._fused_wanted(),
            )
            del probe_state, probe_step
            print(f"batch_size=auto: {dm.batch_size}")
        bs = int(dm.batch_size)
        self.steps_per_epoch = max(1, len(dm.train_arrays) // bs)
        self.tx, self.state, self.train_step = make_step(self.steps_per_epoch)

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

        self.eval_step = build_eval_step(self.model, self.loss_cfg, max_channels=dm.max_channels,
                                         disc=self.disc, normalize=self.normalize)
        self._feeders: Dict[Any, Any] = {}
        self._eval_runners: Dict[str, Any] = {}
        self._generator = torch.Generator(device=self.device)
        self._eval_generator = torch.Generator(device=self.device)

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

        if self._auto_remat and not self._auto_bs:
            self._resolve_remat(ckpt_dir)
        resume_from = cfg.get("resume_from") or ("last" if cfg.get("resume") else None)
        if resume_from:
            target = resume_from if os.path.isabs(str(resume_from)) else os.path.join(ckpt_dir, str(resume_from))
            if os.path.isdir(target):
                self.state = self.ckpt.restore(self.state, target)
                self._load_monitor_state()
                print(f"Resumed from {target} at step {self.state.step}")
            else:
                print(f"resume requested but no checkpoint at {target}; fresh start")
        # the remat=auto decision is recorded now, not first at validation:
        # a run cut before it would otherwise probe again on resume
        if self._resolved_remat is not None:
            self._save_monitor_state()

    # ------------------------------------------------------------------ #

    def _debug(self, name: str) -> bool:
        """`debug.<name>` of the config (profile, nan_checks)."""
        return bool((self.cfg.get("debug") or {}).get(name))

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.start()
        time.sleep(PROFILE_PAD_S)
        return prof

    def _stop_profile(self, prof) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        time.sleep(PROFILE_PAD_S)
        prof.stop()
        path = os.path.join(self.logger.dir, "profile", "trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        print(f"debug.profile: trace of the first steps written to {path}")
        return path

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
        if self._resolved_remat is not None:
            # reused on resume instead of probing (train/autoremat.py:recorded_remat_decision)
            blob["remat_rung"] = self._resolved_remat
            blob["device_cache_dropped"] = bool(self._drop_device_cache)
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

    def _resolve_remat(self, ckpt_dir: str) -> None:
        """`model.remat: auto` (medvae_tpu/train/trainer.py:394-456): the rung
        a launch of this run recorded, when resuming, else the probe of the
        rungs with the production step on a synthetic batch."""
        from medvae_tpu_torch.train.autobatch import synthetic_batch
        from medvae_tpu_torch.train.autoremat import recorded_remat_decision, resolve_auto_remat

        resuming = self.cfg.get("resume") or self.cfg.get("resume_from")
        chosen, drop = recorded_remat_decision(ckpt_dir) if resuming else (None, False)
        self.remat_peaks: Dict[Any, int] = {}
        if chosen is not None:
            print(f"remat=auto: resuming with recorded rung {chosen!r} "
                  f"(device_cache_dropped={drop}, trainer_state.json)")
        else:
            dm = self.datamodule
            batch = synthetic_batch(int(dm.size), int(dm.max_channels), int(dm.batch_size), self.device)
            gen = torch.Generator(device=self.device)

            def run_step() -> None:
                gen.manual_seed(fold_in(self.seed, _PROBE_STREAM))
                self.train_step(self.state, batch, gen)

            chosen, drop = resolve_auto_remat(
                lambda rung: set_remat(self.model, rung), run_step, self.state, self.device,
                reserve_bytes=self._projected_cache_bytes(), droppable_reserve=True, peaks=self.remat_peaks)
        set_remat(self.model, chosen)
        self._resolved_remat, self._drop_device_cache = chosen, drop
        print(f"remat=auto: {chosen!r}" + (" (device caches dropped)" if drop else ""))

    def _device_cache_wanted(self, arrays) -> bool:
        """Would this split be pinned on the device? `data.device_cache`
        (auto: within MEDVAE_DEVICE_CACHE_BUDGET bytes, 2 GiB by default),
        unless remat=auto chose its rung without the caches."""
        mode = str((self.cfg.get("data") or {}).get("device_cache", "auto")).lower()
        if mode not in ("auto", "true", "1", "on") or self._drop_device_cache:
            return False
        budget = int(os.environ.get("MEDVAE_DEVICE_CACHE_BUDGET", 2 << 30))
        return mode != "auto" or split_cache_nbytes(arrays) <= budget

    def _projected_cache_bytes(self) -> int:
        """The bytes the run's device caches will pin (train, val, test): the
        probes hold them as ballast or reserve."""
        return sum(split_cache_nbytes(a) for a in (self.datamodule.split(n) for n in ("train", "val", "test"))
                   if self._device_cache_wanted(a))

    def _fused_mode(self) -> str:
        mode = str((self.cfg.get("training") or {}).get("fused_steps", "auto")).lower()
        return {"true": "on", "1": "on", "false": "off", "0": "off"}.get(mode, mode)

    def _fused_wanted(self) -> bool:
        """Whether the train split will likely take fused chunks (for the
        batch-size probe, before the run's step count is known)."""
        mode = self._fused_mode()
        return mode in ("on", "auto") and self._device_cache_wanted(self.datamodule.train_arrays)

    def _feeder(self, split: str, shuffle: bool, drop_last: bool):
        """One feeder per (split, shuffle, drop_last): the split cached on
        the device when `_device_cache_wanted`, else streamed from host
        memory; each split's resolution said once."""
        key = (split, shuffle, drop_last)
        if key not in self._feeders:
            arrays = self.datamodule.split(split)
            stratify = shuffle and bool((self.cfg.get("data") or {}).get("stratify_batches", False))
            args = (arrays, self.datamodule.batch_size, self.device)
            kwargs = dict(shuffle=shuffle, drop_last=drop_last, seed=self.seed, stratify=stratify)
            feeder = None
            if self._device_cache_wanted(arrays):
                try:
                    feeder = DeviceCachedFeeder(*args, **kwargs)
                except torch.cuda.OutOfMemoryError as e:
                    print(f"device_cache unavailable ({str(e).splitlines()[0]}); streaming from host")
            if feeder is None:
                feeder = DeviceFeeder(*args, **kwargs)
            if all(k[0] != split for k in self._feeders):
                where = "cached on the device" if isinstance(feeder, DeviceCachedFeeder) else "streamed from host"
                print(f"device_cache: {split} split ({split_cache_nbytes(arrays) / 1e6:.1f} MB) {where}")
            self._feeders[key] = feeder
        return self._feeders[key]

    def _seeded(self, stream: int, step: int, generator: Optional[torch.Generator] = None) -> torch.Generator:
        return (generator or self._generator).manual_seed(fold_in(self.seed, stream, step))

    def _eval_runner(self, split: str, feeder):
        """The fused whole-split evaluator of a cached split when fused
        steps are on, or under auto when the run's validations would take
        FUSED_AUTO_MIN_STEPS eval steps; else None (the per-batch loop)."""
        if split not in self._eval_runners:
            from medvae_tpu_torch.train.multistep import build_eval_chunk_runner

            tcfg = self.cfg.get("training") or {}
            validates = int(tcfg.get("max_epochs", 1)) // max(1, int(tcfg.get("check_val_every_n_epoch", 1))) + 2
            mode = self._fused_mode()
            fused = mode == "on" or (mode == "auto" and feeder.steps_per_epoch * validates >= FUSED_AUTO_MIN_STEPS)
            self._eval_runners[split] = (
                build_eval_chunk_runner(self.eval_step, feeder, self._eval_generator)
                if fused and isinstance(feeder, DeviceCachedFeeder) else None)
        return self._eval_runners[split]

    def validate(self, split: str = "val") -> Dict[str, float]:
        """Whole-split metrics: each batch's masked means weighted by its
        valid count, per-modality PSNR, and for the flagship the exact
        whole-split centroid distance of z_modality. The per-batch loop and
        the fused evaluator stack the same per-batch numbers and reduce
        them alike, so both give the same bits."""
        feeder = self._feeder(split, shuffle=False, drop_last=False)
        gen = self._seeded(_EVAL_STREAM, self.state.step, self._eval_generator)
        runner = self._eval_runner(split, feeder)
        if runner is not None:
            stacked = runner(self.state, feeder.steps_per_epoch)
        else:
            rows = [to_host(self.eval_step(self.state, batch, gen)) for batch in feeder.epoch(0)]
            stacked = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
        if self._debug("nan_checks"):
            bad = [k for k, v in stacked.items() if np.isnan(np.asarray(v, np.float64)).any()]
            if bad:
                raise FloatingPointError(f"debug.nan_checks: NaN in {split} metric {bad[0]} at step "
                                         f"{self.state.step}")
        w = np.asarray(stacked.pop("val/_weight"), np.float64)
        psnr_by_mod = np.asarray(stacked.pop("val/_psnr_by_mod"), np.float64).sum(axis=0)
        count_by_mod = np.asarray(stacked.pop("val/_count_by_mod"), np.float64).sum(axis=0)
        zs = stacked.pop("val/_zmod_sum_by_mod", None)
        zmod_sum = None if zs is None else np.asarray(zs, np.float64).sum(axis=0)
        weight_total = float(w.sum())
        acc = {k: float(np.sum(np.asarray(v, np.float64) * w)) for k, v in stacked.items()}
        out = {k: v / max(weight_total, 1.0) for k, v in acc.items()}
        if zmod_sum is not None:
            present = count_by_mod > 0
            if int(present.sum()) >= 2:
                cents = zmod_sum[present] / count_by_mod[present, None]
                d = np.sqrt(((cents[:, None, :] - cents[None, :, :]) ** 2).sum(-1))
                out["val/centroid_distance"] = float(d[np.triu_indices(len(cents), 1)].mean())
        for mod in range(len(psnr_by_mod)):
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
        ckpt_every = int((self.cfg.get("checkpointing") or {}).get("every_n_steps", 0) or 0)
        profile, nan_checks = self._debug("profile"), self._debug("nan_checks")

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
        # fused chunks (medvae_tpu/train/trainer.py:901-933): on a cached
        # train split, when forced or when the run plans enough steps; never
        # under debug.profile (as in JAX) or debug.nan_checks (each step
        # reads its NaN flags back on the host)
        planned = eff_steps * max(0, max_epochs - start_epoch)
        mode = self._fused_mode()
        fused = None
        if (mode in ("on", "auto") and (profile or nan_checks)
                and isinstance(feeder, DeviceCachedFeeder)):
            print(f"fused_steps={mode}: off under " + ("debug.profile" if profile else "debug.nan_checks"))
        elif isinstance(feeder, DeviceCachedFeeder) and (
                mode == "on" or (mode == "auto" and planned >= FUSED_AUTO_MIN_STEPS)):
            from medvae_tpu_torch.train.multistep import build_chunk_runner, chunk_plan

            fused = build_chunk_runner(self.train_step, feeder, self._generator,
                                       lambda step: fold_in(self.seed, _TRAIN_STREAM, step))
        where = "replays of one captured CUDA graph" if self.device.type == "cuda" else "a loop on the CPU"
        print(f"fused_steps={mode}: " + (f"fused chunks of train steps ({where})" if fused else
                                         "one train step a call"))
        t_start, images_seen, first_timed = time.time(), 0, False

        def log_train(step: int, epoch: int, metrics, images: int) -> None:
            nonlocal t_start, images_seen, first_timed
            images_seen += images
            if not first_timed:  # throughput leaves the first call out
                first_timed, t_start, images_seen = True, time.time(), 0
            if step % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["train/images_per_sec"] = images_seen / max(time.time() - t_start, 1e-9)
                host["epoch"] = epoch
                self.logger.log(host, step)
                loss = host.get("train/loss", host.get("train/total_loss", float("nan")))
                print(f"epoch {epoch} step {step} loss {loss:.4f} "
                      f"({host['train/images_per_sec']:.0f} img/s)")

        prof = self._start_profile() if profile else None
        try:
            for epoch in range(start_epoch, max_epochs):
                epoch_t0 = time.time()
                g_base = epoch * self.steps_per_epoch
                if fused is not None:
                    s0 = skip_batches if epoch == start_epoch else 0
                    extra = (g_base + mid_val_at,) if mid_val_at else ()
                    for g0, n in chunk_plan(g_base + eff_steps, g_base + s0, log_every, ckpt_every,
                                            extra=extra):
                        self.state, metrics = fused(self.state, epoch, g0 - g_base, n)
                        step = g0 + n
                        log_train(step, epoch, metrics, n * self.datamodule.batch_size)
                        if ckpt_every and step % ckpt_every == 0:
                            self.ckpt.save_step(self.state)  # refresh `last`
                        if mid_val_at and step - g_base == mid_val_at:
                            last_val = self.validate()
                            self.logger.log(last_val, step)
                for i, batch in enumerate(feeder.epoch(epoch) if fused is None else ()):
                    if limit_train and i >= limit_train:
                        break
                    if epoch == start_epoch and i < skip_batches:
                        continue
                    gen = self._seeded(_TRAIN_STREAM, self.state.step)
                    self.state, metrics = self.train_step(self.state, batch, gen)
                    step = g_base + i + 1
                    log_train(step, epoch, metrics, self.datamodule.batch_size)
                    if prof is not None and step >= min(20, self.steps_per_epoch):
                        self._stop_profile(prof)
                        prof = None
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
            if prof is not None:  # the run ended inside the window
                self._stop_profile(prof)
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
                           dtype=self.model.dtype, normalize=self.normalize)
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
