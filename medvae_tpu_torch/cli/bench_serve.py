"""Serving benchmark of the port: InferenceEngine throughput and latency on
the card (counterpart of scripts/bench_serve.py:50-302).

    python -m medvae_tpu_torch.cli.bench_serve                      # both surfaces
    python -m medvae_tpu_torch.cli.bench_serve --surface quick28    # one surface
    python -m medvae_tpu_torch.cli.bench_serve --tiny               # CPU smoke

Per surface (a shipped experiment's model, random weights from seed 0, bf16
as its config says; serving time does not depend on the weights):

  * every (method, bucket): ms a batch and img/s of reconstruct, encode,
    decode and sample, each the median of at least `--reps` calls (and
    `--min-seconds`) after two warm calls;
  * single-image latency p50/p99 through the bucket-1 path (at least 50
    calls);
  * `MicroBatcher`: concurrent single-image clients against the coalescing
    front end, achieved req/s and the clients' p50/p99.

Times are the host's clock around the engine's public methods, which return
numpy arrays: the copies and the padding are in the number, as a client sees
them. Surfaces: `quick28` (multi_modal_cvae_quick, buckets 1/8/32/128/512,
the MicroBatcher at 32) and `flagship224` (disentangled_multi_modal_cvae_full,
buckets 1/8/32, the MicroBatcher at 8). `--tiny` runs a 16² ConditionalVAE on
the CPU at buckets 1 and 4 (the test tier). Writes `--out`/results.json and
prints a table. The card is used unless `--tiny`; without one it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
from pathlib import Path

import numpy as np
import torch

from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.serve.engine import InferenceEngine, MicroBatcher, input_channels, resolve_device

SURFACES = {
    # the 28² conditional CVAE: the high-throughput serving shape
    "quick28": ("multi_modal_cvae_quick", (1, 8, 32, 128, 512)),
    # the 224² flagship: B1 at its five 56² attention blocks
    "flagship224": ("disentangled_multi_modal_cvae_full", (1, 8, 32)),
}
MICROBATCH = {"quick28": 32, "flagship224": 8}
TINY = {"_target_": "medvae_tpu.models.ConditionalVAE", "input_channels": 3, "num_modalities": 5,
        "latent_dim": 4, "hidden_channels": 8, "ch_mult": [1, 2], "num_res_blocks": 1,
        "attn_resolutions": [], "resolution": 16}


def build_from_experiment(experiment: str, buckets, device=None) -> InferenceEngine:
    """The experiment's model with random weights from seed 0 behind an
    engine on `device` (the card when None)."""
    from medvae_tpu_torch.cli.train import default_config_dir
    from medvae_tpu_torch.config.compose import compose

    cfg = compose(default_config_dir(), "config", [f"experiment={experiment}"])
    dev = resolve_device(device)
    model = init_weights(build_model(dict(cfg["model"]), str(cfg.get("precision", "bf16")), dev), seed=0)
    return InferenceEngine(model, buckets=buckets, device=dev)


def build_tiny(buckets) -> InferenceEngine:
    model = init_weights(build_model(TINY, "fp32", "cpu"), seed=0)
    return InferenceEngine(model, buckets=buckets, device="cpu")


def timed(fn, reps: int, min_seconds: float):
    """(median seconds a call, every sample) over at least `reps` calls and
    `min_seconds`, at most 10·reps, after two warm calls."""
    fn()
    fn()
    times = []
    t_total0 = time.perf_counter()
    while len(times) < reps or time.perf_counter() - t_total0 < min_seconds:
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if len(times) >= 10 * reps:
            break
    return statistics.median(times), times


def pctl(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def bench_surface(name: str, engine: InferenceEngine, reps: int, min_seconds: float) -> dict:
    """Every (method, bucket) cell and the single-image latency."""
    res, c = int(engine.model.resolution), input_channels(engine.model)
    rs = np.random.RandomState(0)
    n_exec = engine.warmup()
    out = {"surface": name, "model": engine.info()["model"], "resolution": res,
           "buckets": list(engine.buckets), "executables_precompiled": n_exec, "cells": []}
    for b in engine.buckets:
        x = rs.randint(0, 255, (b, res, res, c), np.uint8)
        mods = rs.randint(0, 5, (b,), np.int32)
        mean, _ = engine.encode(x, modality=mods)
        for method, fn in (
            ("reconstruct", lambda: engine.reconstruct(x, modality=mods)),
            ("encode", lambda: engine.encode(x, modality=mods)),
            ("decode", lambda: engine.decode(mean, modality=mods)),
            ("sample", lambda: engine.sample(b, modality=mods, seed=0)),
        ):
            sec, _ = timed(fn, reps, min_seconds)
            out["cells"].append({"method": method, "bucket": b, "ms_per_batch": round(sec * 1e3, 3),
                                 "images_per_sec": round(b / sec, 1)})
    x1 = rs.randint(0, 255, (1, res, res, c), np.uint8)
    _, times = timed(lambda: engine.reconstruct(x1, modality=np.zeros((1,), np.int32)), max(reps, 50),
                     min_seconds)
    out["single_image_latency_ms"] = {"p50": round(pctl(times, 0.50) * 1e3, 3),
                                      "p99": round(pctl(times, 0.99) * 1e3, 3), "n": len(times)}
    return out


def bench_microbatcher(engine: InferenceEngine, clients: int, per_client: int, max_batch: int,
                       max_delay_ms: float) -> dict:
    """Concurrent single-image clients through the coalescing front end."""
    res, c = int(engine.model.resolution), input_channels(engine.model)
    imgs = np.random.RandomState(1).randint(0, 255, (clients, res, res, c), np.uint8)
    mb = MicroBatcher(engine, max_batch=max_batch, max_delay_ms=max_delay_ms)
    try:
        for f in [mb.submit(imgs[i % clients]) for i in range(max_batch)]:  # warm the coalesced sizes
            f.result(timeout=120)
        lat, lock = [], threading.Lock()

        def client(i):
            for _ in range(per_client):
                t0 = time.perf_counter()
                mb.submit(imgs[i], modality=int(i % 5)).result(timeout=120)
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        mb.close()
    total = clients * per_client
    return {"clients": clients, "requests": total, "max_batch": max_batch, "max_delay_ms": max_delay_ms,
            "achieved_req_per_sec": round(total / wall, 1),
            "latency_ms": {"p50": round(pctl(lat, 0.50) * 1e3, 3), "p99": round(pctl(lat, 0.99) * 1e3, 3)}}


def print_table(results: dict) -> None:
    for r in results["surfaces"]:
        print(f"\n== {r['surface']} ({r['model']} @ {r['resolution']}²) ==")
        for cell in r["cells"]:
            print(f"  {cell['method']:<11} bs {cell['bucket']:>4}: {cell['ms_per_batch']:>9.2f} ms/batch  "
                  f"{cell['images_per_sec']:>10.1f} img/s")
        lat = r["single_image_latency_ms"]
        print(f"  single-image latency p50 {lat['p50']} ms  p99 {lat['p99']} ms")
        mb = r["microbatcher"]
        print(f"  microbatcher {mb['clients']} clients: {mb['achieved_req_per_sec']} req/s, "
              f"p50 {mb['latency_ms']['p50']} ms p99 {mb['latency_ms']['p99']} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--surface", choices=[*SURFACES, "all"], default="all")
    ap.add_argument("--out", default="logs/serve_bench")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--min-seconds", type=float, default=3.0)
    ap.add_argument("--tiny", action="store_true", help="a tiny model on the CPU (the test tier)")
    args = ap.parse_args(argv)

    if args.tiny:
        engine = build_tiny((1, 4))
        results = {"backend": "cpu", "device": "cpu", "surfaces": []}
        r = bench_surface("tiny16", engine, reps=3, min_seconds=0.0)
        r["microbatcher"] = bench_microbatcher(engine, clients=4, per_client=3, max_batch=4, max_delay_ms=2.0)
        results["surfaces"].append(r)
    else:
        dev = resolve_device(None)
        results = {"backend": "cuda", "device": torch.cuda.get_device_name(dev), "surfaces": []}
        for name in (list(SURFACES) if args.surface == "all" else [args.surface]):
            experiment, buckets = SURFACES[name]
            print(f"[bench_serve] building {name} ({experiment}) ...", flush=True)
            engine = build_from_experiment(experiment, buckets)
            print(f"[bench_serve] warmup + timing {name} ...", flush=True)
            r = bench_surface(name, engine, args.reps, args.min_seconds)
            r["experiment"] = experiment
            r["microbatcher"] = bench_microbatcher(engine, clients=16, per_client=8, max_batch=MICROBATCH[name],
                                                   max_delay_ms=2.0)
            results["surfaces"].append(r)
            del engine
            torch.cuda.empty_cache()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "results.json"
    path.write_text(json.dumps(results, indent=2))
    print_table(results)
    print(f"\n[bench_serve] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
