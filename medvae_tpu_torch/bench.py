"""Throughput of the port on the card: the counterpart of bench.py's three
modes (BENCH_MODE).

    python -m medvae_tpu_torch.bench                      # step (bench.py:391-434)
    BENCH_MODE=pipeline python -m medvae_tpu_torch.bench  # bench.py:310-388
    BENCH_MODE=generate python -m medvae_tpu_torch.bench  # bench.py:265-307

*step*, the default:
BENCH_MODEL=cvae (the default) is bench.py's north-star step: the 28²
ConditionalVAE (`config/models.py:CVAE_BENCH`) at bs 4096, fp32 params with
bf16 compute, the `vae` loss (MSE, kl 1), adam lr 1e-3 constant, clip 1.0,
augment off, max_channels 3, on bench.py's synthetic batch (five modalities
round robin, channels [1, 3, 3, 1, 3], uint8 images from seed 0).
BENCH_MODEL=flagship swaps in the DisentangledConditionalVAE step; with
BENCH_CONFIG=full224 that is the full-scale experiment's step at bs 32 (attention
at 28² and 56², fp32 LPIPS and CLIP-ViT towers unless BENCH_TOWERS=0, adamw
lr 1e-4, augment on). BENCH_CONFIG=full224 alone is the 224² ConditionalVAE
at bs 32. BENCH_BATCH overrides the batch, BENCH_SECONDS (8) the timed window.
MEDVAE_FUSED_GN=1 routes every GroupNorm+SiLU through kernels B6/B7.

*pipeline*: the same step fed by the Trainer's input path over a synthetic
split of BENCH_EPOCH_STEPS (8) batches: the split pinned on the card
(`DeviceCachedFeeder`, the batches assembled there), or with BENCH_CACHE=0
streamed from the host (`DeviceFeeder`: the native gather, pinned copies,
prefetch). A warm-up epoch, then whole epochs for BENCH_SECONDS (12), each
fenced by reading its last loss; `host_feed_duty_cycle` is the share of that
time spent in the feeder's `next`.

*generate*: `sample_conditional` of bench.py's 28² DisentangledConditionalVAE
(`GENERATE_MODEL`, bf16, random weights from seed 0) for BENCH_BATCH (4096)
samples, modalities round robin, each call's noise from a generator seeded
anew, for BENCH_SECONDS (8); samples/s. `use_pallas` there is
MEDVAE_FUSED_GN=1 here.

Each mode prints one JSON line: `metric`, `value`, `unit`, the card's name,
the batch; step and pipeline add `flops_per_step` (torch.utils.flop_counter
over one step: the matmuls and convolutions of forward and backward; the
hand-written kernels are not counted), `achieved_tflops_per_chip` and `mfu`
against the H100's 989 TFLOP/s bf16 dense peak. bench.py's `vs_baseline` is
left out: its target was set for a TPU. Every mode runs on the card only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from medvae_tpu_torch.config.models import CVAE_BENCH, build_model, init_weights
from medvae_tpu_torch.core.rng import fold_in
from medvae_tpu_torch.data.medmnist import SplitArrays
from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder, DeviceFeeder
from medvae_tpu_torch.train.optim import build_optimizer
from medvae_tpu_torch.train.state import create_train_state
from medvae_tpu_torch.train.step import build_train_step, make_frozen

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet

_FULL224 = dict(latent_dim=128, hidden_channels=128, ch_mult=[1, 2, 4, 8], num_res_blocks=2,
                attn_resolutions=[16], resolution=224)
_VAE_LOSS = {"type": "vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0}
# bench.py's generation model (bench.py:268-272)
GENERATE_MODEL = {"_target_": "medvae_tpu.models.DisentangledConditionalVAE", "num_modalities": 5,
                  "latent_dim": 16, "shared_latent_dim": 8, "modality_latent_dim": 8, "hidden_channels": 32,
                  "ch_mult": [1, 2, 4], "num_res_blocks": 1, "attn_resolutions": [], "resolution": 28,
                  "dropout": 0.0}


def bench_config(model: str = "cvae", config: str = "quick",
                 towers: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any], bool, int]:
    """(model config, loss config, optimizer config, augment, default batch)
    of bench.py's `_config` and `_build` (bench.py:96-230)."""
    if config not in ("quick", "full224"):
        raise ValueError(f"BENCH_CONFIG must be quick or full224, got {config!r}")
    full224 = config == "full224"
    arch = dict(_FULL224) if full224 else {
        k: CVAE_BENCH[k] for k in ("latent_dim", "hidden_channels", "ch_mult", "num_res_blocks",
                                   "attn_resolutions", "resolution")
    }
    batch = 32 if full224 else 4096
    adam = {"type": "adam", "lr": 1e-3}
    if model == "cvae":
        return dict(CVAE_BENCH, **arch), dict(_VAE_LOSS), adam, False, batch
    if model != "flagship":
        raise ValueError(f"BENCH_MODEL must be cvae or flagship, got {model!r}")
    latent = arch.pop("latent_dim")
    if full224:
        arch["attn_resolutions"] = [28, 56]
    cfg = dict(arch, _target_="medvae_tpu.models.DisentangledConditionalVAE", num_modalities=5,
               shared_latent_dim=latent // 2, modality_latent_dim=latent // 2, dropout=0.0)
    loss = {"type": "disentangled_vae", "recon_loss_type": "mse", "kl_weight": 1.0,
            "recon_weight": 1.0, "separation_weight": 0.1, "contrastive_weight": 0.2}
    if full224 and towers:
        loss.update(perceptual_weight=0.1, biomedclip_weight=0.1, clip_encoder="vit")
    opt = {"type": "adamw", "lr": 1e-4} if full224 else adam
    return cfg, loss, opt, full224, batch


def synthetic_batch(batch_size: int, size: int, device) -> Dict[str, torch.Tensor]:
    """bench.py's `_synthetic_batch` (bench.py:132-142) as tensors on `device`."""
    rs = np.random.RandomState(0)
    midx = (np.arange(batch_size) % 5).astype(np.int64)
    arrays = {
        "image_u8": rs.randint(0, 255, (batch_size, size, size, 3), np.uint8),
        "modality_onehot": np.eye(12, dtype=np.float32)[midx],
        "modality_idx": midx,
        "channels": np.asarray([1, 3, 3, 1, 3], np.int64)[midx],
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def build_bench(model: str = "cvae", config: str = "quick", batch_size: int | None = None,
                device: Any = "cuda", towers: bool = True, seed: int = 0):
    """(model, step, state, batch): the bench's model with random weights
    from `seed`, its train step, initial state and synthetic batch."""
    model_cfg, loss_cfg, opt_cfg, augment, default_batch = bench_config(model, config, towers)
    net = init_weights(build_model(model_cfg, "bf16", device, train=True), seed)
    tx = build_optimizer(opt_cfg, {"type": "constant"}, gradient_clip_val=1.0)
    state = create_train_state(net, tx, make_frozen(loss_cfg, device, seed=seed))
    step = build_train_step(net, loss_cfg, tx, augment=augment, max_channels=3)
    batch = synthetic_batch(batch_size or default_batch, int(net.resolution), device)
    return net, step, state, batch


def flops_per_step(step, state, batch, generator) -> Tuple[float, Any]:
    """Operations of one step, counted by torch.utils.flop_counter (matmuls
    and convolutions, forward and backward); runs that step."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, batch, generator)
    return float(counter.get_total_flops()), state


def _env_bench():
    """(model, config, batch or None, towers) from BENCH_MODEL, BENCH_CONFIG,
    BENCH_BATCH and BENCH_TOWERS."""
    batch_size = int(os.environ["BENCH_BATCH"]) if os.environ.get("BENCH_BATCH") else None
    return (os.environ.get("BENCH_MODEL", "cvae"), os.environ.get("BENCH_CONFIG", "quick"), batch_size,
            os.environ.get("BENCH_TOWERS", "1") == "1")


def _mfu(flops: float, steps: int, elapsed: float) -> Dict[str, Any]:
    achieved = flops * steps / elapsed
    return {"flops_per_step": flops, "achieved_tflops_per_chip": round(achieved / 1e12, 2),
            "mfu": round(achieved / H100_BF16_FLOPS, 4)}


def step_bench() -> Dict[str, Any]:
    """The default mode: the train step on one resident batch."""
    model_name, config, batch_size, towers = _env_bench()
    _, step, state, batch = build_bench(model_name, config, batch_size, "cuda", towers)
    bs = int(batch["image_u8"].shape[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, metrics = step(state, batch, gen)  # warmup: cuDNN plans, kernel builds
    float(metrics["train/loss"])
    flops, state = flops_per_step(step, state, batch, gen)

    target = float(os.environ.get("BENCH_SECONDS", 8.0))
    steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        state, metrics = step(state, batch, gen)
        steps += 1
        if steps % 10 == 0:
            torch.cuda.synchronize()
            if time.perf_counter() - t0 > target:
                break
    last_loss = float(metrics["train/loss"])
    elapsed = time.perf_counter() - t0
    if last_loss != last_loss:
        raise RuntimeError("NaN loss in benchmark")
    return {
        "metric": f"{model_name}_train_images_per_sec_per_chip",
        "value": round(steps * bs / elapsed, 1),
        "unit": "images/sec/chip",
        **_mfu(flops, steps, elapsed),
        "device": torch.cuda.get_device_name(0),
        "batch": bs,
        "steps": steps,
        "seconds": round(elapsed, 3),
        "fused_gn": os.environ.get("MEDVAE_FUSED_GN") == "1",
    }


def synthetic_split(n: int, size: int) -> SplitArrays:
    """bench.py's synthetic rows (`_synthetic_batch(n, size)`) as a split."""
    batch = synthetic_batch(n, size, "cpu")
    return SplitArrays(images=batch["image_u8"].numpy(), labels=np.zeros((n,), np.int32),
                       modality_idx=batch["modality_idx"].numpy().astype(np.int32), channels=3)


def pipeline_bench() -> Dict[str, Any]:
    """BENCH_MODE=pipeline: the step fed by a feeder, epoch after epoch."""
    model_name, config, batch_size, towers = _env_bench()
    net, step, state, _ = build_bench(model_name, config, batch_size, "cuda", towers)
    bs = batch_size or bench_config(model_name, config, towers)[4]
    steps_per_epoch = int(os.environ.get("BENCH_EPOCH_STEPS", 8))
    arrays = synthetic_split(bs * steps_per_epoch, int(net.resolution))
    cached = os.environ.get("BENCH_CACHE", "1") != "0"
    feeder = (DeviceCachedFeeder if cached else DeviceFeeder)(arrays, bs, "cuda", shuffle=True, drop_last=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in feeder.epoch(0):  # warm-up epoch: cuDNN plans, kernel builds
        state, metrics = step(state, batch, gen)
    float(metrics["train/loss"])
    flops, state = flops_per_step(step, state, batch, gen)

    target = float(os.environ.get("BENCH_SECONDS", 12.0))
    steps, feed_s, epoch = 0, 0.0, 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        it = feeder.epoch(epoch)
        while True:
            th = time.perf_counter()
            try:
                batch = next(it)  # the host's gather and copy, or the card's assembly
            except StopIteration:
                break
            feed_s += time.perf_counter() - th
            state, metrics = step(state, batch, gen)
            steps += 1
        last_loss = float(metrics["train/loss"])  # the epoch's fence
        epoch += 1
        if time.perf_counter() - t0 > target:
            break
    elapsed = time.perf_counter() - t0
    if last_loss != last_loss:
        raise RuntimeError("NaN loss in benchmark")
    return {
        "metric": f"{'flagship' if model_name == 'flagship' else 'cvae'}_train_pipeline_images_per_sec_per_chip",
        "value": round(steps * bs / elapsed, 1),
        "unit": "images/sec/chip",
        "host_feed_duty_cycle": round(feed_s / elapsed, 4),
        **_mfu(flops, steps, elapsed),
        "feeder": type(feeder).__name__,
        "device": torch.cuda.get_device_name(0),
        "batch": bs,
        "steps": steps,
        "epochs": epoch - 1,
        "seconds": round(elapsed, 3),
        "fused_gn": os.environ.get("MEDVAE_FUSED_GN") == "1",
    }


@torch.inference_mode()
def generation_bench() -> Dict[str, Any]:
    """BENCH_MODE=generate: conditional sampling throughput."""
    net = init_weights(build_model(GENERATE_MODEL, "bf16", "cuda", train=False), 0)
    n = int(os.environ.get("BENCH_BATCH", 4096))
    midx = torch.arange(n, device="cuda") % 5
    gen = torch.Generator(device="cuda")
    out = net.sample_conditional(n, midx, generator=gen.manual_seed(0))  # warm-up
    torch.cuda.synchronize()
    target = float(os.environ.get("BENCH_SECONDS", 8.0))
    steps = 0
    t0 = time.perf_counter()
    while True:
        out = net.sample_conditional(n, midx, generator=gen.manual_seed(fold_in(0, steps)))
        steps += 1
        if steps % 10 == 0:
            torch.cuda.synchronize()
            if time.perf_counter() - t0 > target:
                break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite samples in benchmark")
    return {
        "metric": "cvae_generation_samples_per_sec_per_chip",
        "value": round(steps * n / elapsed, 1),
        "unit": "samples/sec/chip",
        "device": torch.cuda.get_device_name(0),
        "batch": n,
        "calls": steps,
        "seconds": round(elapsed, 3),
        "fused_gn": os.environ.get("MEDVAE_FUSED_GN") == "1",
    }


MODES = {"step": step_bench, "pipeline": pipeline_bench, "generate": generation_bench}


def main() -> None:
    mode = os.environ.get("BENCH_MODE", "step")
    if mode not in MODES:
        raise SystemExit(f"medvae_tpu_torch.bench: BENCH_MODE={mode!r}; expected one of {sorted(MODES)}")
    if not torch.cuda.is_available():
        raise SystemExit("medvae_tpu_torch.bench: no CUDA device; the bench runs on the card")
    print(json.dumps(MODES[mode]()))


if __name__ == "__main__":
    main()
