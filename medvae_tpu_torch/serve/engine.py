"""Batched inference engine (counterpart of medvae_tpu/serve/engine.py).

  * batch buckets — a request of any size is cut into chunks of the largest
    bucket, and the tail is padded up to the smallest covering bucket, so the
    device only ever sees len(buckets) batch shapes;
  * deterministic inference — reconstruct and encode use the posterior mean;
    sample takes an explicit seed or draws one from the engine's stream;
  * every model family, as the JAX engine dispatches them
    (medvae_tpu/serve/engine.py:93-94,110-146,213-250): the flagship
    DisentangledConditionalVAE takes modality indices and routes its heads;
    the ConditionalVAE takes a one-hot of `cond_width` and decodes and
    samples unconditionally; Base and Beta take no condition;
  * `MicroBatcher` coalesces concurrent single-image requests;
  * while core/tracing.py records, each chunk's padding and copy to the
    device from pageable memory is an `engine.h2d` span and its model call
    an `engine.launch` device span (host launch ms and device ms).

Images are NHWC uint8 (or float already in [-1, 1]); uint8 is normalized on
the device in fp32 (x/255·2−1). Outputs are float32 in [-1, 1]; `to_uint8`
converts for transport.

The engine runs on the card (`device=None` means "cuda") and raises when
there is none; the CPU is used only when the caller asks for it.

A mesh (medvae_tpu/serve/engine.py:68-86,253-261): `mesh=True` spans every
card of this node from one process, `devices=[...]` the devices named (the
tests pass `["cpu", "cpu"]`). The weights are replicated on each, buckets
round up to multiples of the device count, and a bucket splits into
contiguous shards, each run on its device, the results concatenated. Noise
is drawn for the whole bucket on the first device, as without a mesh, so a
mesh's output equals `mesh=None`'s.
"""

from __future__ import annotations

import copy
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.data.modalities import MODALITY_NAMES, modality_index
from medvae_tpu_torch.models import ConditionalVAE, DisentangledConditionalVAE

DEFAULT_BUCKETS = (1, 8, 32, 128)


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 [0, 255], rounding half to even like the
    engine's on-device output="uint8" conversion."""
    return np.clip(
        np.round((np.asarray(x, np.float32) + 1.0) * 127.5), 0, 255
    ).astype(np.uint8)


def resolve_device(device) -> torch.device:
    """`None` means the card; never falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "InferenceEngine: no CUDA device; pass device='cpu' to run on the CPU"
        )
    return dev


def input_channels(model) -> int:
    """The channels of the images a model takes (the flagship's max_channels)."""
    return int(model.max_channels if isinstance(model, DisentangledConditionalVAE)
               else model.input_channels)


def latent_dim(model) -> int:
    """The channels of a model's spatial latent (the flagship's shared +
    modality)."""
    return int(model.total_latent_dim if isinstance(model, DisentangledConditionalVAE)
               else model.latent_dim)


def cond_width(model) -> int:
    """The one-hot width of the ConditionalVAE's condition head (its cond_dim,
    which may differ from 12); 12 otherwise."""
    return int(model.cond_dim) if isinstance(model, ConditionalVAE) else len(MODALITY_NAMES)


def encode_batch(model, x: torch.Tensor, midx: torch.Tensor):
    """One batch's posterior (mean, logvar) on the model's device, fp32 NHWC:
    uint8 images normalized in fp32 (x/255·2−1), then the family's encode
    (modality indices for the flagship, their fp32 one-hot for the
    ConditionalVAE). The engine's device graph, and serve/export.py's."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0 * 2.0 - 1.0
    if isinstance(model, DisentangledConditionalVAE):
        mean, logvar = model.encode(x, midx)
    elif isinstance(model, ConditionalVAE):
        mean, logvar = model.encode(x, F.one_hot(midx.long(), cond_width(model)).float())
    else:
        mean, logvar = model.encode(x)
    return mean.float(), logvar.float()


def decode_batch(model, z: torch.Tensor, midx: torch.Tensor) -> torch.Tensor:
    """fp32 NHWC images of latents z (the flagship routes its heads by midx)."""
    z = z.to(model.dtype)
    if isinstance(model, DisentangledConditionalVAE):
        return model.decode(z, midx).float()
    return model.decode(z).float()


def sample_batch(model, n: int, midx: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 NHWC prior samples: `noise` (NHWC), or a draw from `generator`,
    decoded; the flagship shifts by modality, the others decode
    unconditionally."""
    if isinstance(model, DisentangledConditionalVAE):
        return model.sample_conditional(n, midx, generator=generator, noise=noise).float()
    return model.sample(n, generator=generator, noise=noise).float()


class InferenceEngine:
    """Shape-bucketed inference over a VAE of any of the port's families."""

    def __init__(
        self,
        model,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        seed: int = 0,
        device=None,
        mesh: bool = False,
        devices: Optional[Sequence] = None,
    ):
        if mesh and devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("InferenceEngine(mesh=True) spans this node's cards and there is none")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            device = devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # the model on each device of the mesh (itself on the first)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d).eval() for d in (devices or [])[1:]]
        self.devices = list(devices) if devices is not None else None
        if self.devices is not None:
            n = len(self.devices)
            buckets = [-(-int(b) // n) * n for b in buckets]
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets: {buckets}")
        self._seeds = torch.Generator().manual_seed(int(seed))
        self._seed_lock = threading.Lock()
        self._is_disentangled = isinstance(model, DisentangledConditionalVAE)
        self._is_conditional = isinstance(model, ConditionalVAE)

    @classmethod
    def from_checkpoint(
        cls, path: str, buckets: Sequence[int] = DEFAULT_BUCKETS, device=None,
        use_ema: bool = False, mesh: bool = False, devices: Optional[Sequence] = None,
    ) -> "InferenceEngine":
        """Serve a port checkpoint (cli/common.py:save_checkpoint); `use_ema`
        serves the EMA weight average a trainer snapshot carries
        (training.ema_decay > 0), the usual deployment choice."""
        from medvae_tpu_torch.cli.common import load_model

        dev = resolve_device(device if devices is None else devices[0])
        return cls(load_model(path, dev, use_ema=use_ema), buckets=buckets, device=dev, mesh=mesh,
                   devices=devices)

    # ------------------------------------------------------------------ #
    # request plumbing                                                    #
    # ------------------------------------------------------------------ #

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _chunks(self, n: int):
        """Yield (start, length, bucket) covering n requests."""
        big = self.buckets[-1]
        lo = 0
        while n - lo > big:
            yield lo, big, big
            lo += big
        if n - lo > 0:
            yield lo, n - lo, self._bucket_for(n - lo)

    @staticmethod
    def _norm_images(images) -> np.ndarray:
        """uint8 passes through (normalized on the device); float input is
        taken as already in [-1, 1]."""
        x = np.asarray(images)
        if x.ndim == 3:
            x = x[None]
        if x.dtype == np.uint8:
            return x
        return np.asarray(x, np.float32)

    def _modality_indices(self, modality, n: int) -> np.ndarray:
        """int32 (n,) modality indices, range-checked against the model."""
        if modality is None:
            midx = np.zeros((n,), np.int32)
        elif isinstance(modality, str):
            midx = np.full((n,), modality_index(modality), np.int32)
        else:
            midx = np.asarray(modality, np.int32).reshape(-1)
            if midx.shape[0] == 1 and n > 1:
                midx = np.full((n,), midx[0], np.int32)
        if midx.shape[0] != n:
            raise ValueError(f"modality length {midx.shape[0]} != batch {n}")
        # a clip would silently serve the wrong modality; the bound is what
        # /info advertises for this model
        bound = int(self.model.num_modalities) if self._is_disentangled else cond_width(self.model)
        if midx.size and (midx.min() < 0 or midx.max() >= bound):
            raise ValueError(
                f"modality index out of range [0, {bound}) for "
                f"{type(self.model).__name__}: {midx[(midx < 0) | (midx >= bound)][:8]}"
            )
        return midx

    def _pad(self, a: np.ndarray, bucket: int) -> torch.Tensor:
        if a.shape[0] != bucket:
            pad = np.zeros((bucket - a.shape[0],) + a.shape[1:], a.dtype)
            a = np.concatenate([a, pad], axis=0)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _put(self, bucket: int, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """A chunk's host arrays padded to `bucket` and copied to the device
        from pageable memory: the `engine.h2d` span."""
        with tracing.span("engine.h2d", bucket=bucket):
            return tuple(self._pad(a, bucket) for a in arrays)

    def _sharded(self, fn, *arrays: torch.Tensor):
        """fn(model, *arrays) on the whole bucket, or over a mesh on each
        device's contiguous shard of it, the results concatenated on the
        first device (a tuple of results concatenated member by member)."""
        if self.devices is None:
            return fn(self.model, *arrays)
        n = len(self.devices)
        rows = arrays[0].shape[0] // n
        outs = [fn(model, *(a[i * rows:(i + 1) * rows].to(dev) for a in arrays))
                for i, (model, dev) in enumerate(zip(self.replicas, self.devices))]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].to(self.device) for o in outs]) for j in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])

    def _next_seed(self) -> int:
        with self._seed_lock:
            return int(torch.randint(0, 2**62, (1,), generator=self._seeds))

    # ------------------------------------------------------------------ #
    # device graphs                                                       #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _to_u8(r: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round((r + 1.0) * 127.5), 0, 255).to(torch.uint8)

    def _finish(self, r: torch.Tensor, output: str, ln: int) -> np.ndarray:
        if output == "uint8":
            r = self._to_u8(r)
        elif output != "float32":
            raise ValueError(f"output must be 'float32' or 'uint8', got {output!r}")
        return r[:ln].cpu().numpy()

    # ------------------------------------------------------------------ #
    # public API                                                          #
    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def reconstruct(self, images, modality=None, output: str = "float32") -> np.ndarray:
        """Deterministic reconstruction: decode of the posterior mean (no
        clamp, as serving calls encode and not the training forward)."""
        x = self._norm_images(images)
        midx = self._modality_indices(modality, x.shape[0])
        outs = []
        for lo, ln, b in self._chunks(x.shape[0]):
            xs, ms = self._put(b, x[lo : lo + ln], midx[lo : lo + ln])
            with tracing.device_span("engine.launch", bucket=b):
                r = self._sharded(lambda model, xs, ms: decode_batch(model, encode_batch(model, xs, ms)[0], ms),
                                  xs, ms)
            outs.append(self._finish(r, output, ln))
        return np.concatenate(outs, axis=0)

    @torch.inference_mode()
    def encode(self, images, modality=None) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (mean, logvar), NHWC float32."""
        x = self._norm_images(images)
        midx = self._modality_indices(modality, x.shape[0])
        means, logvars = [], []
        for lo, ln, b in self._chunks(x.shape[0]):
            xs, ms = self._put(b, x[lo : lo + ln], midx[lo : lo + ln])
            with tracing.device_span("engine.launch", bucket=b):
                mean, logvar = self._sharded(encode_batch, xs, ms)
            means.append(mean[:ln].cpu().numpy())
            logvars.append(logvar[:ln].cpu().numpy())
        return np.concatenate(means), np.concatenate(logvars)

    @torch.inference_mode()
    def decode(self, z, modality=None, output: str = "float32") -> np.ndarray:
        z = np.asarray(z, np.float32)
        midx = self._modality_indices(modality, z.shape[0])
        outs = []
        for lo, ln, b in self._chunks(z.shape[0]):
            zs, ms = self._put(b, z[lo : lo + ln], midx[lo : lo + ln])
            with tracing.device_span("engine.launch", bucket=b):
                r = self._sharded(decode_batch, zs, ms)
            outs.append(self._finish(r, output, ln))
        return np.concatenate(outs, axis=0)

    @torch.inference_mode()
    def sample(
        self, num_samples: int, modality=None, seed=None, output: str = "float32"
    ) -> np.ndarray:
        """Prior samples; seeded explicitly or from the engine's stream."""
        n = int(num_samples)
        midx = self._modality_indices(modality, n)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) if seed is not None else self._next_seed())
        outs = []
        res = int(self.model.encoder_out_res)
        for lo, ln, b in self._chunks(n):
            (ms,) = self._put(b, midx[lo : lo + ln])
            with tracing.device_span("engine.launch", bucket=b):
                if self.devices is None:
                    r = sample_batch(self.model, b, ms, generator=gen)
                else:  # the whole bucket's draw, as without a mesh, then split
                    noise = torch.randn((b, res, res, latent_dim(self.model)), generator=gen,
                                        dtype=torch.float32, device=self.device)
                    r = self._sharded(lambda model, ms, zs: sample_batch(model, zs.shape[0], ms, noise=zs),
                                      ms, noise)
            outs.append(self._finish(r, output, ln))
        return np.concatenate(outs, axis=0)

    def warmup(self) -> int:
        """Run every (method, bucket) once ahead of traffic (kernel builds,
        cuDNN plans, allocator pools); returns how many were run."""
        res = int(self.model.resolution)
        c = input_channels(self.model)
        count = 0
        for b in self.buckets:
            x = np.zeros((b, res, res, c), np.uint8)
            self.reconstruct(x)
            mean, _ = self.encode(x)
            self.decode(mean)
            self.sample(b, seed=0)
            count += 4
        return count

    def info(self) -> Dict[str, Any]:
        m = self.model
        return {
            "model": type(m).__name__,
            "resolution": int(m.resolution),
            "input_channels": input_channels(m),
            "latent_dim": latent_dim(m),
            "buckets": list(self.buckets),
            "modalities": list(MODALITY_NAMES[: m.num_modalities if self._is_disentangled
                                              else cond_width(m)]),
            "conditional": self._is_conditional or self._is_disentangled,
        }


class MicroBatcher:
    """Coalesces concurrent reconstruct requests into device batches: the
    queue is flushed when `max_batch` requests wait or `max_delay_ms` has
    passed since the first one.

    While core/tracing.py records, each request's wait from `submit` until a
    batch takes it is a `batcher.queue` span (`req=`, its parent that batch),
    and each batch, from its first dequeue to its last result set, a
    `batcher.batch` span (`batch=`) holding the engine's spans."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 32,
                 max_delay_ms: float = 5.0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # serializes submit's stop-check + enqueue against close's stop + drain,
        # so that no Future is enqueued after the drain and never resolved
        self._submit_lock = threading.Lock()
        self._reqs, self._batches = itertools.count(), itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, modality=None) -> Future:
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("MicroBatcher is closed")
            fut: Future = Future()
            t = time.perf_counter_ns() if tracing.active() else 0
            self._q.put((np.asarray(image), modality, fut, next(self._reqs), t))
            return fut

    def close(self):
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=5)
        while True:
            try:
                fut = self._q.get_nowait()[2]
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("MicroBatcher closed"))

    @staticmethod
    def _to_index(modality) -> int:
        if modality is None:
            return 0
        if isinstance(modality, str):
            return modality_index(modality)
        return int(np.asarray(modality).reshape(-1)[0])

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            with tracing.span("batcher.batch", batch=next(self._batches)) as bid:
                batch = [self._taken(first, bid)]
                deadline = time.monotonic() + self.max_delay
                while len(batch) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        batch.append(self._taken(self._q.get(timeout=left), bid))
                    except queue.Empty:
                        break
                # a bad request fails its batch's futures, never the thread
                try:
                    mods = np.asarray([self._to_index(b[1]) for b in batch], np.int32)
                    imgs = np.stack([b[0] for b in batch])
                    out = self.engine.reconstruct(imgs, modality=mods)
                    for i, b in enumerate(batch):
                        b[2].set_result(out[i])
                except Exception as e:
                    for b in batch:
                        if not b[2].done():
                            b[2].set_exception(e)

    @staticmethod
    def _taken(item: tuple, batch_id: Optional[int]) -> tuple:
        """A queued request as a batch takes it, its `batcher.queue` span
        ended (when `submit` stamped it)."""
        if item[4]:
            tracing.record("batcher.queue", item[4], time.perf_counter_ns(), parent=batch_id, req=item[3])
        return item
