"""Checkpoints: best-k, last and final train-state snapshots (counterpart of
medvae_tpu/train/checkpoint.py).

The directory layout is the JAX package's: under the experiment's checkpoint
directory, one directory per snapshot (`step_<step>_loss=<metric>` for the
best k by the monitored metric, `last`, `<experiment>_final`) and
`index.json` with the best list. Where orbax writes a tree, the port writes
one `checkpoint.pt` per snapshot with `torch.save`, to a temporary name
renamed into place, so a kill mid-save leaves the previous snapshot whole.

A `checkpoint.pt` is a port checkpoint (cli/common.py: `state_dict`, `model`,
`precision`, so `load_model` and the serving engine take it) plus
`train_state`: the step, the plateau lr_scale, the optimizer's count and
moments and the EMA, and on the GAN path `disc` (the discriminator's params,
BatchNorm buffers and its optimizer's count and moments), all on the CPU in
fp32. `state_dict` holds the generator alone, so a GAN run's checkpoint
serves as any other. `restore` copies them back into a TrainState in place,
which makes a resumed run continue bit for bit.

Over several ranks (`layout`, `writer`, `barrier`): tensors are saved full,
a tensor-parallel shard gathered over the model group first
(parallel/tensor_parallel.py:ShardLayout, a collective every rank takes),
only the writer (rank 0) writes and prunes, and every save ends at a
barrier. Every rank restores, taking its own rows of a sharded tensor, so
a checkpoint resumes under any mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import torch

from medvae_tpu_torch.cli.common import load_checkpoint
from medvae_tpu_torch.train.state import TrainState

FILE = "checkpoint.pt"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        model_cfg: Mapping[str, Any],
        precision: str,
        save_top_k: int = 3,
        monitor: str = "val/loss",
        mode: str = "min",
        save_last: bool = True,
        layout=None,
        writer: bool = True,
        barrier=None,
    ):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.model_cfg = dict(model_cfg)
        self.precision = str(precision)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self._best: List[Dict[str, Any]] = []  # [{"step", "metric", "path"}]
        self._index_path = os.path.join(self.directory, "index.json")
        self.layout, self.writer = layout, writer
        self._barrier = barrier or (lambda: None)
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._best = json.load(f).get("best", [])

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _full(self, param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return _cpu(t if self.layout is None else self.layout.full(param, t))

    def _local(self, param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return t if self.layout is None else self.layout.local(param, t)

    def _save(self, state: TrainState, name: str) -> None:
        full = self._full
        params, dparams = list(state.params.values()), list((state.disc_params or {}).values())
        payload = {
            "state_dict": {k: full(p, p) for k, p in state.params.items()},
            "model": self.model_cfg,
            "precision": self.precision,
            "train_state": {
                "step": int(state.step),
                "lr_scale": float(state.lr_scale),
                "count": int(state.opt_state.count),
                "mu": [full(p, m) for p, m in zip(params, state.opt_state.mu)],
                "nu": [full(p, v) for p, v in zip(params, state.opt_state.nu)],
                "ema": None if state.ema_params is None
                else {k: full(state.params[k], e) for k, e in state.ema_params.items()},
                "disc": None if state.disc_params is None else {
                    "params": {k: full(p, p) for k, p in state.disc_params.items()},
                    "batch_stats": {k: _cpu(b) for k, b in state.disc_batch_stats.items()},
                    "count": int(state.disc_opt_state.count),
                    "mu": [full(p, m) for p, m in zip(dparams, state.disc_opt_state.mu)],
                    "nu": [full(p, v) for p, v in zip(dparams, state.disc_opt_state.nu)],
                },
            },
        }
        if self.writer:
            path = self._path(name)
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, f"{FILE}.tmp.{os.getpid()}")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, FILE))

    def save_step(self, state: TrainState, metrics: Optional[Dict[str, float]] = None) -> None:
        """Save if the monitored metric ranks in the top k (none when
        save_top_k is 0); always refresh `last` (when save_last)."""
        metric = None if metrics is None else metrics.get(self.monitor)
        if metric is not None and self.save_top_k > 0:
            metric = float(metric)
            better = (lambda a, b: a < b) if self.mode == "min" else (lambda a, b: a > b)
            if len(self._best) < self.save_top_k or better(metric, self._best[-1]["metric"]):
                name = f"step_{int(state.step):08d}_loss={metric:.4f}"
                self._save(state, name)
                self._best.append({"step": int(state.step), "metric": metric, "path": self._path(name)})
                self._best.sort(key=lambda e: e["metric"], reverse=(self.mode == "max"))
                while len(self._best) > self.save_top_k:
                    worst = self._best.pop()
                    if self.writer:
                        shutil.rmtree(worst["path"], ignore_errors=True)
                if self.writer:
                    with open(self._index_path, "w") as f:
                        json.dump({"best": self._best, "monitor": self.monitor}, f, indent=2)
        if self.save_last:
            self._save(state, "last")
        self._barrier()

    def save_final(self, state: TrainState, experiment_name: str) -> str:
        name = f"{experiment_name}_final"
        self._save(state, name)
        self._barrier()
        return self._path(name)

    def restore(self, state: TrainState, name: str = "last") -> TrainState:
        """The snapshot `name` (or an absolute path) copied into `state`'s
        params, moments and EMA in place, with its step and lr_scale."""
        ckpt = load_checkpoint(name if os.path.isabs(name) else self._path(name))
        ts = ckpt["train_state"]
        local = self._local
        params = list(state.params.values())
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(local(p, ckpt["state_dict"][k]))
            for dst, p, src in zip(state.opt_state.mu + state.opt_state.nu, params + params,
                                   ts["mu"] + ts["nu"]):
                dst.copy_(local(p, src))
            if state.ema_params is not None and ts["ema"] is not None:
                for k, e in state.ema_params.items():
                    e.copy_(local(state.params[k], ts["ema"][k]))
            disc = ts.get("disc")
            if (state.disc_params is None) != (disc is None):
                raise ValueError(f"{name}: the snapshot {'lacks' if disc is None else 'has'} a "
                                 "discriminator and the run does not match")
            if disc is not None:
                for k, t in state.disc_params.items():
                    t.copy_(local(t, disc["params"][k]))
                for k, t in state.disc_batch_stats.items():
                    t.copy_(disc["batch_stats"][k])
                opt = state.disc_opt_state
                dparams = list(state.disc_params.values())
                for dst, p, src in zip(opt.mu + opt.nu, dparams + dparams, disc["mu"] + disc["nu"]):
                    dst.copy_(local(p, src))
                opt.count = int(disc["count"])
        state.opt_state.count = int(ts["count"])
        return dataclasses.replace(state, step=int(ts["step"]), lr_scale=float(ts["lr_scale"]))
