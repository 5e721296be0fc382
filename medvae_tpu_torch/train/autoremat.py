"""Memory-guided activation-checkpoint selection, `model.remat: auto`
(counterpart of medvae_tpu/train/autoremat.py).

`choose_remat`, `recorded_remat_decision`, `recorded_remat_rung` and the
`RUNTIME_GUARD_BYTES` headroom are the JAX package's, unchanged. What
differs is the probe: the JAX package reads XLA's compile-time memory
assignment of the step, where the port runs one real production step at
each rung (`probe_peak_bytes`) from `torch.cuda.reset_peak_memory_stats` and
reads `torch.cuda.max_memory_allocated`; an out-of-memory error counts as
"does not fit". The run's state is put back after each probe, so probing
moves no weight. `device_hbm_budget` is what this process can allocate on
the card (`torch.cuda.mem_get_info`'s free bytes plus what the caching
allocator already holds), or the `MEDVAE_HBM_BYTES` override.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional, Sequence

import torch

from medvae_tpu_torch.train.autobatch import is_oom_error

# headroom for allocations a probe step cannot see (the fused chunks' graph
# pool, host-transfer staging), as in the JAX package
RUNTIME_GUARD_BYTES = 256 * 2**20

# probe ladder, cheapest recompute first; "conv" is absent, as in JAX
DEFAULT_RUNGS: Sequence[Any] = (False, "block", "full")


def device_hbm_budget(device) -> Optional[int]:
    """Bytes this process can allocate on `device`: MEDVAE_HBM_BYTES when
    set, else the card's free bytes plus what PyTorch's allocator holds;
    None off the card."""
    env = os.environ.get("MEDVAE_HBM_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free) + int(torch.cuda.memory_reserved(device))


def choose_remat(
    probe: Callable[[Any], Optional[int]],
    budget: Optional[int],
    reserve_bytes: int = 0,
    rungs: Sequence[Any] = DEFAULT_RUNGS,
    log: Callable[[str], None] = print,
    droppable_reserve: bool = False,
) -> tuple:
    """Pick the first rung whose probed peak fits; `(rung, drop_reserve)`.
    The JAX package's logic, unchanged (medvae_tpu/train/autoremat.py):
    `probe(rung)` returns the peak in bytes, None when unreadable, and
    raises when the step does not fit; the last rung is the fallback and is
    never probed; `droppable_reserve` lets the device caches go to keep a
    faster rung."""
    need_extra = int(reserve_bytes) + RUNTIME_GUARD_BYTES
    can_drop = droppable_reserve and int(reserve_bytes) > 0
    for rung in rungs[:-1]:
        try:
            peak = probe(rung)
        except Exception as e:  # noqa: BLE001 - any probe failure = no fit
            kind = "OOM" if is_oom_error(e) else "compile failure"
            log(f"autoremat: remat={rung!r} rejected ({kind}: {str(e).splitlines()[0][:120]})")
            continue
        if peak is None:
            if int(reserve_bytes) == 0:
                log(f"autoremat: remat={rung!r} compiles (peak unreadable); selected")
                return rung, False
            if can_drop:
                log(f"autoremat: remat={rung!r} compiles (peak unreadable); dropping the "
                    f"{reserve_bytes / 2**30:.2f} GiB device cache and streaming from host to keep this rung")
                return rung, True
            log(f"autoremat: remat={rung!r} compiles but peak is unreadable and "
                f"{reserve_bytes / 2**30:.2f} GiB of caches are planned; skipping")
            continue
        if budget is not None and peak + need_extra > budget:
            if can_drop and peak + RUNTIME_GUARD_BYTES <= budget:
                log(f"autoremat: remat={rung!r} peak {peak / 2**30:.2f} GiB fits {budget / 2**30:.2f} GiB "
                    f"only without the {reserve_bytes / 2**30:.2f} GiB device cache; keeping the faster "
                    f"rung and streaming batches from host")
                return rung, True
            log(f"autoremat: remat={rung!r} peak {peak / 2**30:.2f} GiB + {need_extra / 2**30:.2f} GiB "
                f"reserve exceeds {budget / 2**30:.2f} GiB budget")
            continue
        if budget is None and int(reserve_bytes) > 0:
            if can_drop:
                log(f"autoremat: remat={rung!r} fits alone (budget unknown); dropping the planned "
                    f"device cache and streaming from host to keep this rung")
                return rung, True
            log(f"autoremat: remat={rung!r} fits alone but the device budget is unknown and caches "
                f"are planned; skipping")
            continue
        log(f"autoremat: remat={rung!r} selected (peak {peak / 2**30:.2f} GiB"
            + (f" of {budget / 2**30:.2f} GiB" if budget is not None else "") + ")")
        return rung, False
    log(f"autoremat: falling back to remat={rungs[-1]!r}")
    return rungs[-1], False


def recorded_remat_decision(ckpt_dir: str) -> tuple:
    """(remat rung, drop_device_cache) a previous launch resolved and wrote
    to `trainer_state.json` ("remat_rung", "device_cache_dropped"), or
    (None, False); a resumed run reuses it instead of probing again."""
    path = os.path.join(ckpt_dir, "trainer_state.json")
    if not os.path.exists(path):
        return None, False
    try:
        with open(path) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return None, False
    rung = blob.get("remat_rung", None)
    if rung not in (False, "block", "full"):
        return None, False
    return rung, bool(blob.get("device_cache_dropped", False))


def recorded_remat_rung(ckpt_dir: str):
    """The remat rung a previous launch of this run resolved, or None."""
    return recorded_remat_decision(ckpt_dir)[0]


def _state_tensors(state) -> list:
    """Every tensor a train step updates in place."""
    out = list(state.params.values()) + state.opt_state.mu + state.opt_state.nu
    if state.ema_params is not None:
        out += list(state.ema_params.values())
    if state.disc_params is not None:
        out += list(state.disc_params.values()) + list(state.disc_batch_stats.values())
        out += state.disc_opt_state.mu + state.disc_opt_state.nu
    return out


def probe_peak_bytes(run_step: Callable[[], None], state, device) -> Optional[int]:
    """The peak device bytes of `run_step()` (one production step on
    `state`), from a reset of the card's peak counter (None off the card,
    where the step only runs); `state` is put back after, from the host
    copy taken before. Raises what the step raises (an OOM among it) after
    putting the state back."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    saved = [t.detach().to("cpu", copy=True) for t in _state_tensors(state)]
    counts = (state.opt_state.count, None if state.disc_opt_state is None else state.disc_opt_state.count)
    try:
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        run_step()
        if not cuda:
            return None
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    finally:
        with torch.no_grad():
            for t, host in zip(_state_tensors(state), saved):
                t.copy_(host)
        state.opt_state.count = counts[0]
        if counts[1] is not None:
            state.disc_opt_state.count = counts[1]
        if cuda:
            torch.cuda.empty_cache()


def resolve_auto_remat(
    set_rung: Callable[[Any], None],
    run_step: Callable[[], None],
    state,
    device,
    reserve_bytes: int = 0,
    rungs: Sequence[Any] = DEFAULT_RUNGS,
    log: Callable[[str], None] = print,
    droppable_reserve: bool = False,
    peaks: Optional[dict] = None,
) -> tuple:
    """Resolve `remat: auto` on the card: `(rung, drop_reserve)`.
    `set_rung(rung)` moves the run's model to a rung (nn/encoder_decoder.py:
    set_remat) and `run_step()` takes one production step; each probed
    rung's peak goes into `peaks` when given. Off the card nothing can be
    measured, and the fallback rung is taken without probing, as the JAX
    package does off the TPU."""
    device = torch.device(device)
    if device.type != "cuda":
        log(f"autoremat: no card ({device}); using remat={rungs[-1]!r} without probing")
        return rungs[-1], False

    def probe(rung) -> int:
        set_rung(rung)
        peak = probe_peak_bytes(run_step, state, device)
        if peaks is not None:
            peaks[rung] = peak
        return peak

    chosen, drop = choose_remat(probe, device_hbm_budget(device), reserve_bytes=reserve_bytes,
                                rungs=rungs, log=log, droppable_reserve=droppable_reserve)
    set_rung(chosen)
    return chosen, drop
