"""Fused multi-step training: chunks of train steps as one captured CUDA
graph, replayed (counterpart of medvae_tpu/train/multistep.py).

The JAX package runs K steps in one jitted `lax.scan` that assembles each
batch in-graph from the device-cached split. On the card the port does the
same with a `torch.cuda.CUDAGraph`: `build_chunk_runner` captures ONE train
step (`TrainStep.run`) whose batch is assembled in the graph from the cached
split (`DeviceCachedFeeder.assemble`) at a step index held in a static 0-d
device tensor, and replays it `n_steps` times with no host sync in between.
Before each replay the host

  * re-seeds the step's generator (registered with the graph, and the
    microbatch generators with it) from `seed_of(state.step)`, as the
    Trainer seeds its per-step calls (`Trainer._seeded`), and
  * calls `TrainStep.prepare`, which fills the step's scalars (learning
    rate, bias corrections, lr_scale, the GAN gate) into their static
    tensors, and writes the step index;

after it, `TrainStep.finish` advances the counts. A replay then draws what
the per-step call draws and runs the same kernels on the same addresses, so
a chunk equals the per-step loop bit for bit. The last step's metrics are
read once at the chunk's end, as JAX returns `last`.

The first step a runner takes runs eagerly: it is the warm-up (kernel
builds, entry points, cuDNN plans, and over a process group the NCCL
communicator, whose collectives the graph then holds) that happens outside
the capture, and a real step. `capture=False` makes the runner the Python
loop on the card too: the Trainer asks for it when the collectives go
through gloo, which copies through the host and cannot be captured. A failed capture or replay raises; on the card there is no
fallback to the Python loop. On the CPU (the tests) the runner is that loop
over the same step with the same seeding.

The kernels' launch counters (ops/*.py `launches`) count a launch on the
host where the wrapper issues it, which under capture happens once. The
runner records each counter's capture-time increments and adds them again
at every replay, so the counts stay the launches a replay issues as long
as the graph replays what it captured; chip_smoke.py holds them against
the kernel events of the replays' profiler trace.

`build_eval_chunk_runner` captures the eval step the same way over the whole
split, each replay writing its metrics into one static (batches, width)
buffer that comes back in one device-to-host copy. `chunk_plan` is the JAX
package's, unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from medvae_tpu_torch.ops import adamw, attention, flash_attention, groupnorm_swish

_COUNTED = (attention, flash_attention, groupnorm_swish, adamw)


def _launch_counts() -> Dict[Tuple[int, str], int]:
    return {(i, name): n for i, mod in enumerate(_COUNTED) for name, n in mod.launches.items()}


def _add_launches(delta: Dict[Tuple[int, str], int], times: int) -> None:
    for (i, name), n in delta.items():
        if n:
            mod = _COUNTED[i]
            with mod._count_lock:
                mod.launches[name] += n * times


class _Captured:
    """One captured call: the graph, and the launches it issues a replay
    (counted by the wrappers while capturing, which launches nothing, so
    taken back from the counters until a replay)."""

    def __init__(self, fn: Callable[[], object], generators: list):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = _launch_counts()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = _launch_counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after}
        _add_launches(self.launches, -1)

    def replay(self) -> None:
        self.graph.replay()
        _add_launches(self.launches, 1)


def build_chunk_runner(step, feeder, generator: torch.Generator, seed_of: Callable[[int], int],
                       capture: Optional[bool] = None) -> Callable:
    """Couple a `TrainStep` with a `DeviceCachedFeeder`.

    Returns run(state, epoch, step0, n_steps) -> (state, metrics): steps
    step0 .. step0 + n_steps - 1 of `epoch`'s order, `generator` seeded with
    `seed_of(state.step)` before each, `metrics` the last step's."""
    device = feeder.device
    cuda = device.type == "cuda" if capture is None else bool(capture)
    held: Dict[str, object] = {"epoch": None}

    def seeded(state):
        generator.manual_seed(seed_of(state.step))
        step.prepare(state, generator)

    def run(state, epoch: int, step0: int, n_steps: int):
        if held["epoch"] != epoch:
            held["perm"] = feeder.epoch_perm(epoch)
            if "captured" in held:
                held["perm_static"].copy_(held["perm"])
            held["epoch"] = epoch
        metrics = None
        for i in range(n_steps):
            if not cuda or "captured" not in held:
                # the CPU loop, and on the card the first step: eager, the
                # capture's warm-up
                seeded(state)
                batch = feeder.assemble(held["perm"], torch.tensor(step0 + i, device=device))
                metrics = step.run(state, batch, generator)
                state = step.finish(state)
                if cuda:
                    held["perm_static"] = held["perm"].clone()
                    held["step_t"] = torch.zeros((), dtype=torch.int64, device=device)
                    torch.cuda.synchronize(device)
                    held["captured"] = _Captured(
                        lambda: step.run(state, feeder.assemble(held["perm_static"], held["step_t"]),
                                         generator), [generator, *step.microbatch_generators(generator)])
                continue
            seeded(state)
            held["step_t"].fill_(step0 + i)
            held["captured"].replay()
            state = step.finish(state)
            metrics = held["captured"].out
        return state, {k: v.clone() for k, v in metrics.items()}

    return run


def build_eval_chunk_runner(eval_step, feeder, generator: torch.Generator,
                            capture: Optional[bool] = None) -> Callable:
    """Whole-split evaluation in replays of one captured eval step.

    Returns run(state, n_steps) -> {name: (n_steps, ...) numpy}: the eval
    metrics of the split's first n_steps batches, drawing from `generator`
    in turn as the per-batch loop does (the caller seeds it), fetched in one
    device-to-host copy."""
    device = feeder.device
    cuda = device.type == "cuda" if capture is None else bool(capture)
    perm = feeder.epoch_perm(0)
    held: Dict[str, object] = {}

    def layout(metrics):
        return [(k, tuple(v.shape), v.dtype) for k, v in metrics.items()]

    def flat(metrics):
        return torch.cat([v.reshape(-1).to(torch.float32) for v in metrics.values()])

    def unpack(rows: np.ndarray) -> Dict[str, np.ndarray]:
        out, col = {}, 0
        for k, shape, dtype in held["layout"]:
            width = int(np.prod(shape))
            out[k] = rows[:, col:col + width].reshape((rows.shape[0],) + shape).astype(
                str(dtype).replace("torch.", ""))
            col += width
        return out

    def run(state, n_steps: int) -> Dict[str, np.ndarray]:
        eval_step.prepare(state)
        rows = []
        for i in range(n_steps):
            if cuda and "captured" in held:
                held["index"].fill_(i)
                held["captured"].replay()
                continue
            metrics = eval_step.run(state, feeder.assemble(perm, torch.tensor(i, device=device)), generator)
            held.setdefault("layout", layout(metrics))
            if not cuda:
                rows.append(flat(metrics))
                continue
            # the card's first batch: eager (the warm-up), then the capture
            held["rows"] = torch.zeros((feeder.steps_per_epoch, sum(int(np.prod(s)) for _, s, _ in held["layout"])),
                                       dtype=torch.float32, device=device)
            held["rows"][i] = flat(metrics)
            held["index"] = torch.zeros((), dtype=torch.int64, device=device)
            torch.cuda.synchronize(device)

            def body():  # index_copy_ takes the device index without a sync
                row = flat(eval_step.run(state, feeder.assemble(perm, held["index"]), generator))
                held["rows"].index_copy_(0, held["index"].reshape(1), row[None])

            held["captured"] = _Captured(body, [generator])
        if cuda:
            return unpack(held["rows"][:n_steps].cpu().numpy())
        return unpack(torch.stack(rows).cpu().numpy())

    return run


def chunk_plan(
    total_steps: int, start: int, *boundaries_every: int,
    extra: Tuple[int, ...] = (),
) -> Tuple[Tuple[int, int], ...]:
    """((step0, n_steps), ...) covering [start, total_steps), cut at every
    multiple of each cadence in `boundaries_every` (log_every,
    checkpoint-every, ...; 0/negative cadences ignored) and at each absolute
    step in `extra` (e.g. a mid-epoch validation point) so the host regains
    control exactly where the per-step loop would have acted."""
    cuts = {total_steps}
    cuts.update(extra)
    for every in boundaries_every:
        if every and every > 0:
            cuts.update(range(0, total_steps + 1, every))
    points = sorted(c for c in cuts if start < c <= total_steps)
    plan = []
    lo = start
    for hi in points:
        plan.append((lo, hi - lo))
        lo = hi
    return tuple(plan)
