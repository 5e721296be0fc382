"""`train` entry point (counterpart of medvae_tpu/cli/train.py).

    python -m medvae_tpu_torch.cli.train experiment=chest_base_vae_quick device=cpu ...
    python -m medvae_tpu_torch.cli.train -m experiment=multi_modal_cvae_quick \
        training.optimizer.lr=1e-3,2e-3 data.dataset=chestmnist,pathmnist

Composes the repo's `configs/` tree with Hydra's override syntax
(config/compose.py), writes the composed config and the overrides into the
run directory (`<log_dir>/<experiment_name>/`), then trains: seed, model,
datamodule, fit, test, final checkpoint (train/trainer.py). The device
defaults to the configs' `tpu`, which the port reads as the card; `device=cpu`
trains on the CPU.

Multirun (`-m`): the swept overrides (config/sweep.py's grammar) expand into
the cartesian product of jobs, run one after another in this process, each in
its own `<log_dir>/multirun/<stamp>/<job>` directory (its log_dir, and what
interpolates it, such as checkpoint_dir). `summary.json` in the sweep
directory lists each job's `job`, `overrides`, `label`, `status`, `val`,
`test` and `seconds` (and `error` for a failed job, which is recorded, the
summary written, and the exception raised again), as the JAX CLI's does.
Before each job the process is brought back to a fresh start
(`fresh_process_state`), so a job's numbers do not depend on the jobs before
it.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path

from medvae_tpu_torch.config.compose import compose, save_yaml


def default_config_dir() -> str:
    """$MEDVAE_CONFIG_DIR, else the nearest `configs/` with a config.yaml
    above this file."""
    env = os.environ.get("MEDVAE_CONFIG_DIR")
    if env:
        return env
    for parent in Path(__file__).resolve().parents:
        if (parent / "configs" / "config.yaml").exists():
            return str(parent / "configs")
    return "configs"


def _capture_run_dir(cfg, overrides) -> None:
    run_dir = os.path.join(cfg.get("log_dir", "logs"), cfg.get("experiment_name", "run"))
    os.makedirs(run_dir, exist_ok=True)
    save_yaml(cfg, os.path.join(run_dir, "config.yaml"))
    save_yaml(list(overrides), os.path.join(run_dir, "overrides.yaml"))


def fresh_process_state() -> None:
    """Drop what a finished job leaves in the process: its tensors, CUDA
    graphs and their pools (collected, the allocator's cache emptied), the
    kernel wrappers' and the native gather's counters, and the backend flags
    (core/precision.py:configure_backends, cuDNN's autotuner off). Each
    Trainer makes its own model (remat rungs included), generators and
    steps."""
    import torch

    from medvae_tpu_torch import native
    from medvae_tpu_torch.core.precision import configure_backends
    from medvae_tpu_torch.ops import attention, flash_attention, groupnorm_swish

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for mod in (attention, flash_attention, groupnorm_swish):
        mod.reset_launches()
    native.calls = 0
    configure_backends()
    torch.backends.cudnn.benchmark = False


def _run_one(overrides) -> tuple:
    """Compose and train once; returns (val metrics, test metrics)."""
    cfg = compose(default_config_dir(), "config", overrides)
    _capture_run_dir(cfg, overrides)

    from medvae_tpu_torch.train.trainer import Trainer

    print(f"Experiment: {cfg.get('experiment_name')}")
    trainer = Trainer(cfg)
    val = trainer.fit()
    test = trainer.test()
    print("Validation:", {k: round(v, 5) for k, v in val.items()})
    print("Test:", {k: round(v, 5) for k, v in test.items()})
    return val, test


def run_multirun(overrides) -> int:
    """`-m`: expand the sweep, run the jobs in turn, summarize
    (medvae_tpu/cli/train.py:70-131)."""
    from medvae_tpu_torch.config.sweep import expand_multirun, job_label

    jobs, swept_keys = expand_multirun(overrides)
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    print(f"Multirun: {len(jobs)} job(s), sweeping {swept_keys or '(nothing)'}")
    # the sweep directory from job 0's log_dir, so that a swept work_dir or
    # log_dir still gives one directory; each job's log_dir goes under it
    base_log = compose(default_config_dir(), "config", jobs[0]).get("log_dir", "logs")
    sweep_dir = os.path.join(str(base_log), "multirun", stamp)
    results = []
    try:
        for num, job in enumerate(jobs):
            job_overrides = job + [f"log_dir={os.path.join(sweep_dir, str(num))}"]
            label = job_label(job, swept_keys)
            print(f"\n=== job {num}/{len(jobs) - 1}: {label or '(fixed)'} ===")
            entry = {"job": num, "overrides": job, "label": label}
            results.append(entry)
            fresh_process_state()
            t0 = time.time()
            try:
                val, test = _run_one(job_overrides)
                entry.update(status="ok", val={k: float(v) for k, v in val.items()},
                             test={k: float(v) for k, v in test.items()})
            except Exception as e:  # recorded, then raised again
                entry.update(status="error", error=f"{type(e).__name__}: {e}")
                raise
            finally:
                entry["seconds"] = round(time.time() - t0, 1)
                gc.collect()
    finally:
        _write_sweep_summary(sweep_dir, results)
    monitor = "val/loss"
    print(f"\nMultirun summary ({len(results)} jobs) -> {sweep_dir}")
    for r in results:
        v = (r.get("val") or {}).get(monitor)
        shown = f"{monitor}={v:.5f}" if v is not None else r["status"]
        print(f"  [{r['job']}] {r['label'] or '(fixed)'}: {shown}")
    return 0


def _write_sweep_summary(sweep_dir, results) -> None:
    os.makedirs(sweep_dir, exist_ok=True)
    with open(os.path.join(sweep_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in args if a not in ("-m", "--multirun")]
    if len(overrides) != len(args):
        return run_multirun(overrides)
    _run_one(overrides)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
