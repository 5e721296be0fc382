"""Training traffic: the port's train step, fed by its host feeder, as
fast as it goes.

Set-up builds one train state and step as the port's Trainer composes them
for the configuration (`build_model` with the Trainer's remat rung,
`make_frozen` towers, `build_optimizer`, `create_train_state`, the GAN's
discriminator and its optimizer, `build_train_step`), with every weight
made from the seed, over a synthetic split in host memory fed by
`DeviceFeeder` (modality-stratified, the Trainer's feeder for a split over
its 2 GiB device-cache budget, as every MedMNIST 224² split is). The state
counter starts at the configuration's `start_step` (the GAN's gate). Each
step's reparameterization noise and augmentation draws are the benchmark's,
drawn from the seed and handed in through the step's `batch["noise"]` and
`draws`.

The first `check_steps` steps run in set-up through the window's own call
and feed: each one's losses are read, the first gradient's leaf norms from
the optimizer's first moments after step 1, and each leaf's change after
the last of them. The window then steps on for `--seconds`; the rate is the
images of every step started in the window over the window's seconds, which
end in a synchronize. After the window, with the program's state freed, the
plain reference takes the same rows (found in the split by their bytes),
noise and draws through the same steps, and `compare.train_gaps` holds the
readings against each other.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

from portbench import compare, data, weights
from portbench.common import Run, sub_seed, sync
from portbench.reference import runner


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.cfg: Dict[str, Any] = run.cell["model"]
        self.mix: Dict[str, Any] = run.cell["mix"]
        self.bs = int(self.cfg["data"]["batch_size"])

    # ------------------------------------------------------------ set-up ---- #

    def setup(self) -> None:
        import torch

        from medvae_tpu_torch.config.models import build_model
        from medvae_tpu_torch.data.medmnist import SplitArrays
        from medvae_tpu_torch.data.pipeline import DeviceFeeder
        from medvae_tpu_torch.nn.discriminator import build_discriminator
        from medvae_tpu_torch.nn.encoder_decoder import set_remat
        from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
        from medvae_tpu_torch.train.state import create_train_state
        from medvae_tpu_torch.train.step import build_train_step, make_frozen

        run, cfg, seed = self.run, self.cfg, self.run.seed
        parts = run.setup_parts
        t = time.perf_counter()
        dev = self.device = torch.device(run.device)
        dcfg = cfg["data"]
        self.split = data.make_split(int(self.mix["split_rows"]), int(dcfg["size"]), int(dcfg["n_modalities"]),
                                     sub_seed(seed, runner.DATA_STREAM), dev)
        arrays = SplitArrays(self.split["images"], self.split["labels"], self.split["modality_idx"], 3)
        self.steps_per_epoch = len(arrays) // self.bs
        parts["data_s"] = time.perf_counter() - t

        t = time.perf_counter()
        loss_cfg = runner.loss_cfg_of(cfg)
        model = build_model(cfg["model"], cfg["precision"], dev, train=True)
        set_remat(model, cfg["remat"])
        weights.load(model, weights.make(runner.model_spec(cfg), sub_seed(seed, runner.MODEL_STREAM), dev))
        frozen = make_frozen(loss_cfg, dev)
        for key, net in frozen.items():
            weights.load(net, weights.make(runner.tower_specs(cfg)[key], runner.tower_seed(seed, key), dev))
        opt = (dict(cfg["optimizer"]), dict(cfg.get("scheduler") or {}))
        kw = dict(steps_per_epoch=self.steps_per_epoch, gradient_clip_val=cfg.get("gradient_clip_val", 1.0))
        tx = build_optimizer(*opt, **kw)
        disc = disc_tx = None
        if "discriminator" in cfg:
            disc = build_discriminator(loss_cfg["discriminator"], dev, seed=0)
            weights.load(disc, weights.make(runner.disc_spec(cfg), sub_seed(seed, runner.DISC_STREAM), dev))
            disc_tx = discriminator_optimizer(*opt, **kw)
        self.tx, self.disc_tx = tx, disc_tx
        self.state = create_train_state(model, tx, frozen, disc=disc, disc_tx=disc_tx)
        self.state.step = int(cfg.get("start_step", 0))
        self.augment = bool(dcfg["augment_train"])
        self.step = build_train_step(model, loss_cfg, tx, augment=self.augment,
                                     max_channels=int(dcfg["max_channels"]), disc=disc, disc_tx=disc_tx)
        self.feeder = DeviceFeeder(arrays, self.bs, dev, shuffle=True, drop_last=True, seed=seed % (1 << 32),
                                   stratify=bool(dcfg.get("stratify_batches", False)))
        self.batches = self._endless()
        self.noise_shape = runner.noise_shape(cfg, self.bs)
        self.steps_done = 0
        sync(self.device)
        parts["model_and_state_s"] = time.perf_counter() - t

        # the first steps: warm-up, and the readings the reference checks
        t = time.perf_counter()
        self.fed_rows: List[List[int]] = []
        losses = []
        index = data.RowIndex(self.split["images"])
        keys = list(self.mix["loss_keys"])
        for i in range(int(self.mix["check_steps"])):
            metrics, batch = self.one_step(keep_batch=True)
            losses.append({k: float(metrics[k]) for k in keys})
            self.fed_rows.append(index.rows_of(batch["image_u8"].cpu().numpy()))
            if i == 0:
                grads = runner.first_grad_norms(self.state, tx, disc_tx)
                parts["first_step_s"] = time.perf_counter() - t
        init = weights.make(runner.model_spec(cfg), sub_seed(seed, runner.MODEL_STREAM), dev)
        dinit = (weights.make(runner.disc_spec(cfg), sub_seed(seed, runner.DISC_STREAM), dev)
                 if disc is not None else None)
        self.readings = {"losses": losses, "grads": grads,
                         "changes": runner.change_norms(self.state, init, dinit)}
        del init, dinit
        sync(self.device)
        parts["warmup_s"] = time.perf_counter() - t

    def _endless(self):
        epoch = 0
        while True:
            yield from self.feeder.epoch(epoch)
            epoch += 1

    def one_step(self, keep_batch: bool = False):
        """One step of the window: the feeder's next batch, the benchmark's
        noise and draws for it, the port's step."""
        rec = self.run.record
        with rec.span("feed"):
            batch = next(self.batches)
        noise, draws = runner.step_inputs(self.noise_shape, self.run.seed, self.steps_done, self.device,
                                          self.augment)
        batch["noise"] = noise
        with rec.span("step"):
            self.state, metrics = self.step(self.state, batch, None, draws)
        self.steps_done += 1
        return metrics, (batch if keep_batch else None)

    # ------------------------------------------------------------ window ---- #

    def window(self, seconds: float) -> None:
        import torch

        run = self.run
        sync(self.device)
        first = self.steps_done
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        while time.perf_counter_ns() < end:
            self.one_step()
        sync(self.device)
        t1 = time.perf_counter_ns()
        run.window_bounds = (t0, t1)
        run.window_s = (t1 - t0) / 1e9
        steps = self.steps_done - first
        run.work = {"steps": steps, "images": steps * self.bs, "attempted": steps, "failed": 0}
        run.kernel_calls = {k: [tuple([self.bs] + list(s)) for s in shapes] * steps
                            for k, shapes in self.cfg.get("kernel_sites", {}).items()}

    def end_to_end(self) -> Dict[str, float]:
        return {"train_img_per_s": self.run.work["images"] / self.run.window_s}

    def flops_per_unit(self) -> float:
        """The reference's FLOPs of one train step at the cell's shapes
        (convolutions, matmuls, attention; forward and backward), counted on
        the meta device."""
        return runner.train_step_flops(self.cfg, self.bs)

    # ------------------------------------------------------------- check ---- #

    def release(self) -> None:
        for name in ("state", "step", "feeder", "batches"):
            setattr(self, name, None)
        gc.collect()

    def check(self) -> Dict[str, Any]:
        import torch

        rows = self.fed_rows
        flat = [r for b in rows for r in b]
        numbers: Dict[str, Any] = {"rows_unmatched": sum(r < 0 for r in flat),
                                   "rows_repeated": len(flat) - len(set(flat))}
        batches = []
        for i, b in enumerate(rows):
            batch = data.batch_of(self.split, [max(r, 0) for r in b], self.device)
            noise, draws = runner.step_inputs(self.noise_shape, self.run.seed, i, self.device, self.augment)
            batch["noise"], batch["draws"] = noise, draws
            batches.append(batch)
        torch.cuda.empty_cache()
        ref = runner.train_readings(self.cfg, self.run.seed, batches, self.device, self.steps_per_epoch,
                                    "fp32", tuple(self.mix["loss_keys"]))
        numbers.update(compare.train_gaps(self.readings, ref, self.mix.get("grad_leaves", "")))
        numbers["_loss_program"] = [l for l in self.readings["losses"]]
        numbers["_loss_reference"] = ref["losses"]
        return numbers
