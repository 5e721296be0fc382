"""Evaluation traffic: a closed loop of the port's `cli/evaluate.py:
eval_batch` over a test split, as the evaluate CLI walks it.

Set-up builds the model as the CLI loads a checkpoint (`build_model` of the
configuration with its precision, eval mode), with weights made from the
seed, and a synthetic test split in host memory fed by `DeviceFeeder` in
order (no shuffle, the ragged tail wrapped round with `valid` 0), at the
configuration's batch size, as the CLI takes it. Each batch's
reparameterization noise is the benchmark's, drawn from the batch's own
seed. A batch is `eval_batch` and one device-to-host copy of its metrics
(`to_host`), as in the CLI; the loop walks the split again when it ends.

The rate is the valid images of every batch started in the window over the
window's seconds, which end in a synchronize. A sample of the window's
batches, drawn from the seed as they come, keeps its reconstruction and metrics;
after the window the plain reference evaluates the same rows with the same
noise, and the reconstructions and metrics are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict

import numpy as np

from portbench import compare, data, weights
from portbench.common import Run, sub_seed, sync
from portbench.reference import runner

SAMPLE_STREAM, EVAL_NOISE_STREAM = 4, 2000


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.cfg: Dict[str, Any] = run.cell["model"]
        self.mix: Dict[str, Any] = run.cell["mix"]
        self.bs = int(self.cfg["data"]["batch_size"])

    def setup(self) -> None:
        import torch

        from medvae_tpu_torch.config.models import build_model
        from medvae_tpu_torch.data.medmnist import SplitArrays
        from medvae_tpu_torch.data.pipeline import DeviceFeeder

        run, cfg, mix, seed = self.run, self.cfg, self.mix, self.run.seed
        parts = run.setup_parts
        dev = self.device = torch.device(run.device)
        t = time.perf_counter()
        self.split = data.make_split(int(mix["split_rows"]), int(cfg["data"]["size"]),
                                     int(cfg["data"]["n_modalities"]), sub_seed(seed, runner.DATA_STREAM), dev)
        arrays = SplitArrays(self.split["images"], self.split["labels"], self.split["modality_idx"], 3)
        self.rng = np.random.default_rng(sub_seed(seed, SAMPLE_STREAM))
        parts["data_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.model = build_model(cfg["model"], cfg["precision"], dev, train=False)
        weights.load(self.model, weights.make(runner.model_spec(cfg), sub_seed(seed, runner.MODEL_STREAM), dev))
        self.feeder = DeviceFeeder(arrays, self.bs, dev, shuffle=False, drop_last=False, seed=0)
        self.batches = self._endless()
        self.noise_shape = runner.noise_shape(cfg, self.bs)
        sync(dev)
        parts["model_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.done = 0
        self.kept: Dict[int, Any] = {}  # the window's sample of batches, by batch number
        self.first = None  # the window's first batch number
        for _ in range(int(mix["warmup_batches"])):
            self.one_batch()
        sync(dev)
        parts["warmup_s"] = time.perf_counter() - t

    def _endless(self):
        while True:
            yield from self.feeder.epoch(0)

    def noise(self, i: int):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.run.seed, EVAL_NOISE_STREAM + i))
        return torch.randn(self.noise_shape, generator=gen, device=self.device)

    def one_batch(self) -> int:
        """One batch of the window, as the CLI runs it; returns its valid
        images."""
        from medvae_tpu_torch.cli.evaluate import eval_batch
        from medvae_tpu_torch.train.metrics import to_host

        rec, i = self.run.record, self.done
        with rec.span("feed"):
            batch = next(self.batches)
        noise = self.noise(i)
        with rec.span("eval"):
            m, x, rec_img, mean = eval_batch(self.model, batch, noise=noise)
            fetched = to_host(m)
        slot = self._slot(i)
        if slot is not None:
            self.kept.pop(slot, None)
            self.kept[i] = {"rec": rec_img.float().cpu(), "metrics": fetched,
                            "images": batch["image_u8"].cpu().numpy(), "valid": batch["valid"].cpu().numpy()}
        self.done += 1
        return int(round(float(fetched["_count_by_mod"].sum())))

    def _slot(self, i: int):
        """Reservoir sampling over the window's batches, with draws from the
        seed: None to skip batch `i`; else the batch it replaces in the
        sample (`i` itself while the sample fills). Every batch of the window
        ends in the sample with the same chance, however many there are."""
        if self.first is None:
            return None
        k, j = int(self.mix["batches_sample"]), i - self.first
        if j < k:
            return i
        r = int(self.rng.integers(0, j + 1))
        return sorted(self.kept)[r] if r < k else None

    def window(self, seconds: float) -> None:
        run = self.run
        sync(self.device)
        first, images = self.done, 0
        self.first = first
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        while time.perf_counter_ns() < end:
            images += self.one_batch()
        sync(self.device)
        t1 = time.perf_counter_ns()
        run.window_bounds = (t0, t1)
        run.window_s = (t1 - t0) / 1e9
        batches = self.done - first
        run.work = {"batches": batches, "images": images, "attempted": batches, "failed": 0}

    def end_to_end(self) -> Dict[str, float]:
        return {"eval_img_per_s": self.run.work["images"] / self.run.window_s}

    def flops_per_unit(self) -> float:
        """The reference's FLOPs of one image's forward (encode, decode)."""
        return runner.forward_flops(self.cfg, 1)

    def release(self) -> None:
        self.model = self.feeder = self.batches = None
        gc.collect()

    def check(self) -> Dict[str, Any]:
        import torch

        from portbench.reference import model as ref_model
        from portbench.reference.metrics import kl_metrics, latent_metrics, psnr, reconstruction_metrics
        from portbench.reference.preprocess import preprocess
        from portbench.reference.step import make_forward_fn

        dev, ids = self.device, sorted(self.kept)
        index = data.RowIndex(self.split["images"])
        want_n = min(int(self.mix["batches_sample"]), self.run.work["batches"])
        numbers: Dict[str, Any] = {"sampled_missing": want_n - len(ids), "rows_unmatched": 0}
        model = ref_model.build(self.cfg["model"], dev, train=False)
        weights.load(model, weights.make(runner.model_spec(self.cfg), sub_seed(self.run.seed, runner.MODEL_STREAM),
                                         dev))
        forward = make_forward_fn(model)
        pairs, gaps = [], {k: 0.0 for k in ("psnr_gap_db", "ssim_gap", "metric_rel_gap")}
        with torch.no_grad():
            for i in ids:
                if i not in self.kept:
                    continue
                got = self.kept[i]
                rows = index.rows_of(got["images"])
                numbers["rows_unmatched"] += sum(r < 0 for r in rows)
                batch = data.batch_of(self.split, [max(r, 0) for r in rows], dev)
                batch["valid"] = torch.as_tensor(got["valid"], device=dev)
                x = preprocess(batch, None, augment=False, max_channels=3, dtype=torch.float32)
                out = forward(x, {**batch, "noise": self.noise(i)}, None)
                rec, valid = out["reconstruction"], batch["valid"]
                want = {**reconstruction_metrics(rec, x, valid), **kl_metrics(out["mean"], out["logvar"], valid),
                        **latent_metrics(out["z"], valid)}
                onehot = torch.nn.functional.one_hot(batch["modality_idx"], data.N_MODALITIES_ALL).float() * valid[:, None]
                want["_psnr_by_mod"] = (psnr(rec.float(), x.float())[:, None] * onehot).sum(dim=0)
                want["_count_by_mod"] = onehot.sum(dim=0)
                pairs.append((got["rec"].to(dev), rec.float()))
                have = got["metrics"]
                gaps["psnr_gap_db"] = max(gaps["psnr_gap_db"], abs(float(have["psnr"]) - float(want["psnr"])),
                                          float(np.max(np.abs(have["_psnr_by_mod"] - want["_psnr_by_mod"].cpu().numpy())
                                                       / np.maximum(want["_count_by_mod"].cpu().numpy(), 1.0))))
                gaps["ssim_gap"] = max(gaps["ssim_gap"], abs(float(have["ssim"]) - float(want["ssim"])))
                for k in ("mse", "kl_total", "latent_std"):
                    w = float(want[k])
                    gaps["metric_rel_gap"] = max(gaps["metric_rel_gap"], abs(float(have[k]) - w) / max(abs(w), 1e-12))
                if not np.array_equal(have["_count_by_mod"], want["_count_by_mod"].cpu().numpy()):
                    gaps["metric_rel_gap"] = float("inf")
        numbers["recon_rel_l2"] = compare.max_rel_l2(pairs) if pairs else float("inf")
        numbers.update(gaps)
        return numbers
