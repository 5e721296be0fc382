"""The 16-channel KL-f8 autoencoder of SD3 / FLUX.1 (`config/models.py:
KL_F8_C16`) at 1024², bs 8, on the card, held to the published AutoencoderKL:

    python scripts/klf8c16_card.py [--seed N] [--out build/klf8c16_card.json]

Weights: the published model in plain PyTorch (portbench/reference/
autoencoder_kl.py, the diffusers layout) seeded as the benchmark seeds every
model (portbench/weights.py), then mapped into the port's BaseVAE through
compat/diffusers_import.py. A batch of eight synthetic 1024² uint8 images
runs through the port as it is served and evaluated in bf16:
`InferenceEngine(buckets=(8,)).reconstruct` (decode of the posterior mean,
of the images as uint8 scaled to [-1, 1]) and `cli/evaluate.py:eval_batch`
(decode of mean + std·noise, of the images as the benchmark's frozen
preprocessing gives them), with the
routes the gates took and the kernels' launches counted on one call each,
and both timed. The port in fp32 (its serving build in fp32: B1's and B6's
fp32 instances) runs the same calls. The reference computes each image
alone in fp32 with TF32 off, and every output is compared by relative L2,
image by image; the worst is printed beside its bar:

  * the port in fp32: 1e-4, the rounding of fp32 math taken in another
    order (the kernels' reductions, cuDNN's algorithms) through ~60 layers;
  * the port in bf16: 0.06, the evaluation cell's limit on `recon_rel_l2`
    (portbench/workloads/klf8c16_eval.json), whose calibration PERF.md
    gives.

Nothing of JAX is imported. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BARS = {"fp32": 1e-4, "bf16": 0.06}


def _published():
    spec = importlib.util.spec_from_file_location("autoencoder_kl", ROOT / "portbench/reference/autoencoder_kl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _timed(fn, repeats: int):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / repeats, (time.perf_counter() - t) * 1e3 / repeats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2**31 + 16)
    p.add_argument("--out", default=str(ROOT / "build" / "klf8c16_card.json"))
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("klf8c16_card: no CUDA device", file=sys.stderr)
        return 2
    from medvae_tpu_torch.cli.evaluate import eval_batch
    from medvae_tpu_torch.compat.diffusers_import import convert_diffusers_state_dict
    from medvae_tpu_torch.config.models import KL_F8_C16, build_model
    from medvae_tpu_torch.core import tracing
    from medvae_tpu_torch.serve import InferenceEngine
    from medvae_tpu_torch.train.metrics import to_host
    from portbench import data, weights
    from portbench.reference.preprocess import preprocess

    dev = torch.device("cuda")
    akl = _published()
    akl.configure()
    ref = akl.AutoencoderKL().to(dev).eval().requires_grad_(False)
    weights.load(ref, weights.make(weights.spec(ref), args.seed, dev))
    bs, size = 8, int(KL_F8_C16["resolution"])
    split = data.make_split(bs, size, 5, args.seed + 1, dev)
    batch = data.batch_of(split, list(range(bs)), dev)
    images = split["images"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    noise = torch.randn((bs, size // 8, size // 8, 16), generator=gen, device=dev)
    x = torch.as_tensor(images, device=dev).permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
    x_eval = preprocess(batch, None, augment=False, max_channels=3, dtype=torch.float32).permute(0, 3, 1, 2)

    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__, "seed": args.seed,
           "params": sum(q.numel() for q in ref.parameters()), "bars": BARS}
    t = time.perf_counter()
    with torch.no_grad():  # the reference, an image at a time
        want_rec = torch.cat([ref.reconstruct(x[i:i + 1]) for i in range(bs)])
        want_fwd = torch.cat([ref(x_eval[i:i + 1], noise[i:i + 1].permute(0, 3, 1, 2)) for i in range(bs)])
    torch.cuda.synchronize()
    out["reference_s"] = time.perf_counter() - t
    state = {k: v.cpu() for k, v in ref.state_dict().items()}
    del ref
    torch.cuda.empty_cache()

    for precision in ("bf16", "fp32"):
        model = build_model(KL_F8_C16, precision, dev, train=False)
        model.load_state_dict(convert_diffusers_state_dict(state, build_model(KL_F8_C16, "fp32", "meta")))
        engine = InferenceEngine(model, buckets=(bs,), device=dev)
        torch.cuda.reset_peak_memory_stats()
        rec, engine_ms, engine_host_ms = _timed(lambda: engine.reconstruct(images), args.repeats)
        (m, _, rec_eval, _), eval_ms, _ = _timed(lambda: eval_batch(model, batch, noise=noise), args.repeats)
        peak = torch.cuda.max_memory_allocated()
        from medvae_tpu_torch.ops import flash_attention, groupnorm_swish

        tracing.reset()
        tracing.enable(True)
        before = {**{f"b1.{k}": v for k, v in flash_attention.launches.items()},
                  **{f"gn.{k}": v for k, v in groupnorm_swish.launches.items()}}
        engine.reconstruct(images)
        torch.cuda.synchronize()
        tracing.enable(None)
        after = {**{f"b1.{k}": v for k, v in flash_attention.launches.items()},
                 **{f"gn.{k}": v for k, v in groupnorm_swish.launches.items()}}
        counts = {k: v for k, v in tracing.counters().items() if k.startswith(("attn.", "gn.")) and "bytes" not in k}
        tracing.reset()
        metrics = to_host(m)
        gaps = {
            "engine_reconstruct": max(_rel(torch.as_tensor(rec[i]).permute(2, 0, 1), want_rec[i].cpu())
                                      for i in range(bs)),
            "eval_batch_forward": max(_rel(rec_eval[i].float().permute(2, 0, 1), want_fwd[i]) for i in range(bs)),
        }
        out[precision] = {
            "gaps": gaps, "bar": BARS[precision], "within": max(gaps.values()) <= BARS[precision],
            "route_counts_one_reconstruct": counts,
            "launches_one_reconstruct": {k: after[k] - before[k] for k in after},
            "engine_reconstruct_ms": engine_ms, "engine_reconstruct_host_ms": engine_host_ms,
            "eval_batch_ms": eval_ms, "img_per_s_eval_batch": bs / eval_ms * 1e3,
            "peak_bytes": int(peak), "psnr": float(metrics["psnr"]),
        }
        print(json.dumps({precision: out[precision]}), flush=True)
        del model, engine, rec, rec_eval, m
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    ok = all(out[p]["within"] for p in BARS)
    print(f"klf8c16_card: {'ok' if ok else 'FAILED'}; reference {out['reference_s']:.1f} s; "
          f"{out['params']} params; {out['card']}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
