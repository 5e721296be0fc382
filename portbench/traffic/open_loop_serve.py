"""Serving traffic: an open loop of single-image reconstruct requests
through the port's `MicroBatcher` over its `InferenceEngine`.

Set-up builds the serving model (`build_model(..., train=False)`: conv
weights in the compute dtype, eval mode) with weights made from the seed,
the engine with the configuration's buckets, and warms up `reconstruct` at
each bucket alone (the only calls the batcher makes), then starts the
batcher. The benchmark wraps the engine instance's `reconstruct` to count
requests and bucket slots a call and to time the host inside it.

The mix fixes the rate. A run of `--seconds` sends rate × seconds requests
at times drawn from the seed (a Poisson process given its count: sorted
uniform times over the window), each a 224² uint8 image from a pool made
from the seed, with the modality uniform over the configuration's
(equal counts, in an order drawn from the seed). One thread sends each
request when it is due; each is timed from when it was due to when its
future is resolved, a minute past the window's close at the most; a request
that fails or never comes counts as missing every limit (latency
infinite). `serve_p95_ms` is the 95th percentile over every request.

After the window a sample of the requests, drawn from the seed before it
opened, is held against the plain reference's reconstruct of its own image
and modality: a result handed to another request fails.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Dict

import numpy as np

from portbench import compare, data, weights
from portbench.common import Run, sub_seed, sync
from portbench.reference import runner

REQUEST_STREAM = 3
LATE_WAIT_S = 60.0  # how long past the window's close an answer may come


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.cfg: Dict[str, Any] = run.cell["model"]
        self.mix: Dict[str, Any] = run.cell["mix"]

    def setup(self) -> None:
        import torch

        from medvae_tpu_torch.config.models import build_model
        from medvae_tpu_torch.serve.engine import InferenceEngine, MicroBatcher

        run, cfg, mix, seed = self.run, self.cfg, self.mix, self.run.seed
        parts = run.setup_parts
        dev = self.device = torch.device(run.device)
        t = time.perf_counter()
        size, n_mod = int(cfg["data"]["size"]), int(cfg["data"]["n_modalities"])
        pool = data.make_split(int(mix["pool_images"]), size, n_mod, sub_seed(seed, runner.DATA_STREAM), dev)
        self.pool = pool["images"]
        rng = np.random.default_rng(sub_seed(seed, REQUEST_STREAM))
        n = self.n = max(1, int(round(float(mix["rate_per_s"]) * run.seconds)))
        self.due = np.sort(rng.uniform(0.0, run.seconds, n))
        self.modality = rng.permutation(np.arange(n) % n_mod).astype(np.int32)
        self.image_of = rng.permutation(np.arange(n) % len(self.pool))
        sample = min(int(mix["requests_sample"]), n)
        self.sample = set(int(i) for i in rng.choice(n, sample, replace=False))
        parts["data_s"] = time.perf_counter() - t

        t = time.perf_counter()
        model = build_model(cfg["model"], cfg["precision"], dev, train=False)
        weights.load(model, weights.make(runner.model_spec(cfg), sub_seed(seed, runner.MODEL_STREAM), dev))
        scfg = cfg["serve"]
        self.engine = InferenceEngine(model, buckets=tuple(scfg["buckets"]), device=dev)
        self.buckets = self.engine.buckets
        self.output = str(scfg["output"])
        sync(dev)
        parts["model_s"] = time.perf_counter() - t

        t = time.perf_counter()
        for b in self.buckets:  # every shape the batcher can make, twice
            if b <= int(scfg["max_batch"]):
                for k in range(2):
                    tb = time.perf_counter()
                    self.engine.reconstruct(self.pool[np.arange(b) % len(self.pool)],
                                            modality=np.arange(b) % n_mod, output=self.output)
                    parts[f"warmup_bucket{b}_{k}_s"] = time.perf_counter() - tb
        sync(dev)
        parts["warmup_s"] = time.perf_counter() - t
        self._wrap_engine()
        self.batcher = MicroBatcher(self.engine, max_batch=int(scfg["max_batch"]),
                                    max_delay_ms=float(scfg["max_delay_ms"]))

    def _wrap_engine(self) -> None:
        engine, rec = self.engine, self.run.record
        inner = engine.reconstruct
        self.calls = []  # (requests, bucket slots) of each engine call in the window

        def reconstruct(images, modality=None, output="float32"):
            if rec.on:
                n = len(images)
                slots = sum(b for _, _, b in engine._chunks(n))
                self.calls.append((n, slots))
            with rec.span("engine"):
                return inner(images, modality=modality, output=output)

        engine.reconstruct = reconstruct

    def window(self, seconds: float) -> None:
        run, n = self.run, self.n
        done_at = np.full(n, np.nan)
        failed = np.zeros(n, bool)
        sent_at = np.zeros(n)
        kept: Dict[int, np.ndarray] = {}
        remaining = [n]
        all_done = threading.Event()
        lock = threading.Lock()

        def finish(i: int, fut) -> None:
            t = time.perf_counter()
            ok = fut.exception() is None
            with lock:
                done_at[i] = t
                failed[i] = not ok
                if ok and i in self.sample:
                    kept[i] = np.array(fut.result(), copy=True)
                remaining[0] -= 1
                if remaining[0] == 0:
                    all_done.set()

        sync(self.device)
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        for i in range(n):
            due = t0 + self.due[i]
            while True:
                left = due - time.perf_counter()
                if left <= 0:
                    break
                time.sleep(min(left, 0.002) if left > 0.002 else 0)
            sent_at[i] = time.perf_counter()
            try:
                fut = self.batcher.submit(self.pool[self.image_of[i]], modality=int(self.modality[i]))
            except RuntimeError:
                with lock:
                    failed[i], remaining[0] = True, remaining[0] - 1
                continue
            fut.add_done_callback(lambda f, i=i: finish(i, f))
        close = t0 + seconds
        all_done.wait(timeout=max(0.0, close - time.perf_counter()) + LATE_WAIT_S)
        sync(self.device)
        t1_ns = time.perf_counter_ns()
        run.window_bounds = (t0_ns, t1_ns)
        run.window_s = (t1_ns - t0_ns) / 1e9
        with lock:
            lat = np.where(np.isnan(done_at) | failed, np.inf, done_at - (t0 + self.due))
            self.kept = dict(kept)
            missing = int(np.sum(np.isnan(done_at) | failed))
        self.latency_s = lat
        self.late_s = sent_at - (t0 + self.due)
        outstanding_at_close = int(np.sum((t0 + self.due <= close) & ~(done_at <= close)))
        images = sum(c[0] for c in self.calls)
        run.work = {"requests": n, "attempted": n, "failed": missing, "images": images,
                    "engine_calls": len(self.calls), "slots": sum(c[1] for c in self.calls),
                    "outstanding_at_close": outstanding_at_close}
        run.record.counters.update(calls=list(self.calls), late_s=self.late_s)
        run.kernel_calls = {k: [tuple([slots] + list(s)) for _, slots in self.calls for s in shapes]
                            for k, shapes in self.cfg.get("kernel_sites", {}).items() if k == "flash_fwd"}

    def end_to_end(self) -> Dict[str, float]:
        return {"serve_p95_ms": float(np.percentile(self.latency_s, 95)) * 1e3}

    def flops_per_unit(self) -> float:
        """The reference's FLOPs of one reconstruct of one image."""
        return runner.forward_flops(self.cfg, 1)

    def release(self) -> None:
        self.batcher.close()
        self.batcher = self.engine = None
        gc.collect()

    def check(self) -> Dict[str, Any]:
        import torch

        from portbench.reference import model as ref_model

        dev = self.device
        ids = sorted(self.sample)
        numbers: Dict[str, Any] = {"sampled_missing": sum(i not in self.kept for i in ids)}
        model = ref_model.build(self.cfg["model"], dev, train=False)
        weights.load(model, weights.make(runner.model_spec(self.cfg), sub_seed(self.run.seed, runner.MODEL_STREAM),
                                         dev))
        pairs = []
        block = int(self.mix.get("reference_block", 16))
        have = [i for i in ids if i in self.kept]
        with torch.no_grad():
            for lo in range(0, len(have), block):
                part = have[lo:lo + block]
                x = torch.as_tensor(self.pool[self.image_of[part]], device=dev).float() / 255.0 * 2.0 - 1.0
                midx = torch.as_tensor(self.modality[part].astype(np.int64), device=dev)
                want = runner._reconstruct(model, x, midx).float()
                for j, i in enumerate(part):
                    pairs.append((torch.as_tensor(self.kept[i], device=dev), want[j]))
        numbers["recon_rel_l2"] = compare.max_rel_l2(pairs) if pairs else float("inf")
        return numbers
