"""Automatic batch sizing, `data.batch_size: auto`: the largest batch that
fits the card (counterpart of medvae_tpu/train/autobatch.py).

`is_oom_error` (which also takes `torch.cuda.OutOfMemoryError`) and
`probe_max_batch_size` are the JAX package's: double from `start` until a
candidate does not fit or the cap is reached, then bisect the bracket to the
exact maximum, within `max_probes` candidates, none probed twice.

`resolve_auto_batch_size` probes with the production step on a synthetic
batch of each candidate size on the run's own state, which is put back
after each candidate (train/autoremat.py:probe_peak_bytes), while a device
allocation of the projected dataset-cache bytes is held as ballast; after a
candidate that does not fit, `torch.cuda.empty_cache()` hands its blocks
back. When the run will take fused chunks (train/multistep.py), a candidate
is also captured as a CUDA graph, the path that will run, since the graph's
private pool holds its activations apart.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from medvae_tpu_torch.data.modalities import MODALITY_NAMES


def is_oom_error(e: BaseException) -> bool:
    """True when an exception is a device out-of-memory failure."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return any(
        s in msg
        for s in (
            "RESOURCE_EXHAUSTED",
            "Out of memory",
            "out of memory",
            "OOM",
            "Resource exhausted",
            "exceeds the amount of memory available",
        )
    )


def probe_max_batch_size(
    try_fn: Callable[[int], None],
    start: int = 64,
    max_batch: int = 65536,
    multiple: int = 1,
    log: Callable[[str], None] = print,
    max_probes: int = 16,
) -> int:
    """Largest b (multiple of `multiple`, ≤ max_batch) for which try_fn(b)
    does not OOM (the JAX package's search, unchanged). try_fn runs one
    real step at batch b and raises on failure; OOM errors shrink the
    search, any other exception propagates."""
    def _round(b: int) -> int:
        return max(multiple, (b // multiple) * multiple)

    probes = 0

    def attempt(b: int) -> bool:
        nonlocal probes
        probes += 1
        try:
            try_fn(b)
            log(f"autobatch: {b} fits")
            return True
        except Exception as e:  # noqa: BLE001 - filtered by is_oom_error
            if not is_oom_error(e):
                raise
            log(f"autobatch: {b} OOM")
            return False

    start = _round(min(start, max_batch))
    good: Optional[int] = None
    bad: Optional[int] = None
    b = start
    while True:
        if attempt(b):
            good = b
            if b >= max_batch:
                log(f"autobatch: selected {good} (cap)")
                return _round(b)
            if bad is not None:
                break
            if probes >= max_probes:
                log(f"autobatch: probe budget ({max_probes}) reached while doubling; keeping {good}")
                return good
            b = min(b * 2, max_batch)
        else:
            bad = b
            if good is not None:
                break
            if b <= multiple:
                raise MemoryError(f"even batch {b} does not fit device memory")
            b = _round(max(multiple, b // 2))
    while bad - good > multiple and probes < max_probes:
        mid = _round((good + bad) // 2)
        if mid <= good or mid >= bad:
            break
        if attempt(mid):
            good = mid
        else:
            bad = mid
    if bad - good > multiple:
        log(f"autobatch: probe budget ({max_probes}) reached with bracket ({good}, {bad}); keeping {good}")
    log(f"autobatch: selected {good}")
    return good


def synthetic_batch(size: int, channels: int, b: int, device) -> dict:
    """A production-shaped batch of zero images with the modalities in
    turn (medvae_tpu/train/autoremat.py:synthetic_host_batch)."""
    midx = (np.arange(b) % len(MODALITY_NAMES)).astype(np.int32)
    host = {
        "image_u8": np.zeros((b, size, size, channels), np.uint8),
        "label": np.zeros((b,), np.int32),
        "modality_onehot": np.eye(len(MODALITY_NAMES), dtype=np.float32)[midx],
        "modality_idx": midx,
        "channels": np.full((b,), channels, np.int32),
        "valid": np.ones((b,), np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def resolve_auto_batch_size(
    step,
    state,
    datamodule,
    device,
    start: int = 64,
    max_batch: int = 65536,
    max_probes: int = 16,
    ballast_bytes: int = 0,
    captured: bool = False,
    log: Callable[[str], None] = print,
    rows_cap: Optional[int] = None,
) -> int:
    """The largest global batch the production `step` takes on the card,
    probed on synthetic batches against `state` (module docstring); capped
    by `max_batch` and the train split's size (`rows_cap` when a rank
    probes its share of the batch: the split's size over the batch extent)."""
    from medvae_tpu_torch.train.autoremat import probe_peak_bytes

    device = torch.device(device)
    cap = min(int(max_batch), max(1, len(datamodule.train_arrays) if rows_cap is None else int(rows_cap)))
    generator = torch.Generator(device=device)
    ballast = None
    if ballast_bytes > 0:
        ballast = torch.empty((int(ballast_bytes),), dtype=torch.uint8, device=device)
        log(f"autobatch: holding {ballast_bytes / 1e6:.0f} MB cache ballast during probe")

    def try_fn(b: int) -> None:
        batch = synthetic_batch(int(datamodule.size), int(datamodule.max_channels), b, device)

        def run_step():
            generator.manual_seed(99)
            _, metrics = step(state, batch, generator)
            next(iter(metrics.values())).item()  # the step has run
            if captured:
                graph = torch.cuda.CUDAGraph()
                for gen in (generator, *step.microbatch_generators(generator)):
                    graph.register_generator_state(gen)
                with torch.cuda.graph(graph):
                    step.run(state, batch, generator)
                del graph

        try:
            probe_peak_bytes(run_step, state, device)
        finally:
            del batch

    try:
        return probe_max_batch_size(try_fn, start=start, max_batch=cap, log=log, max_probes=max_probes)
    finally:
        del ballast
        if device.type == "cuda":
            torch.cuda.empty_cache()
