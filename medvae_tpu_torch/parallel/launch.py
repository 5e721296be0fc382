"""Start a function on n ranks of this machine, each a process of its own,
and collect what each returns (the dry runs and the tests).

`spawn(fn, world, ...)` starts `world` spawned processes, each with one
torch thread, a default group from a `file://` store under `store_dir` (no
port, so concurrent jobs cannot collide), and `local_world` ranks a node
(one node unless given: `local_world=2` of a world of 4 makes two nodes and
a dcn axis). The ranks compute on `device`: the CPU under gloo, or the
card (`cuda`), where core/mesh.py picks NCCL when each rank has a card of
its own and gloo when they share one. Rank r runs `fn(r, *args)`; its return value comes back through
a file. Every process is joined within `timeout` seconds: one that hangs
(a collective its peers never reach) or exits non-zero fails the call, and
the others are killed, so nothing outlives it.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch


def _child(fn, rank: int, world: int, local_world: int, store: str, out: str, args, device: str) -> None:
    from medvae_tpu_torch.core import mesh as core_mesh

    torch.set_num_threads(1)
    try:
        core_mesh.init_distributed(device, init_method=f"file://{store}", rank=rank, world_size=world,
                                   local_world_size=local_world, host_world_size=world)
        result = fn(rank, *args)
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise
    finally:
        core_mesh.shutdown()


def spawn(fn: Callable, world: int, *, store_dir: str, args: Sequence[Any] = (),
          local_world: Optional[int] = None, timeout: float = 300.0, device: str = "cpu") -> List[Any]:
    """[fn(r, *args) for r in range(world)], each on its own rank; see the
    module docstring."""
    import torch.multiprocessing as mp

    os.makedirs(store_dir, exist_ok=True)
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    store = os.path.join(store_dir, f"store_{tag}")
    outs = [os.path.join(store_dir, f"rank{r}_{tag}.pt") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, local_world or world, store, outs[r], tuple(args), device), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after {timeout:.0f} s")
        results = []
        for r, p in enumerate(procs):
            got = torch.load(outs[r], weights_only=False) if os.path.exists(outs[r]) else None
            if p.exitcode != 0 or got is None or not got["ok"]:
                why = got["error"] if got else f"exit code {p.exitcode}, no result"
                raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
            results.append(got["result"])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for path in outs + [store]:
            if os.path.exists(path):
                os.remove(path)
