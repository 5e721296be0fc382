"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic mix and driver are found by name (portbench/common.py). The run
makes its inputs and weights from `--seed`, sets up and warms up the port
(`medvae_tpu_torch`), measures for `--seconds` seconds, then, with the
port's state freed, holds what the timed path produced against the plain
reference (portbench/reference/) and prints the compared numbers beside
their limits as the last lines on standard error. The last line on standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics, read
from the traced window by portbench/metrics/<name>.py), `device`, with
`--trace 1` `breakdown`, and `checks` last.

It exits non-zero and prints no result where there is no card or fewer
than the cell asks for, where the port is not there, or where `jax`,
`jaxlib`, `flax` or `medvae_tpu` were loaded by the end of the run. Every
build and kernel cache goes under build/portbench_cache/ in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # Python's bytecode cache of every module the run imports, torch's
    # included, at a fixed path in the checkout: the first run compiles it,
    # later runs read it (the environment may forbid writing bytecode beside
    # the installed packages, and then every run compiled them again)
    sys.pycache_prefix = str(ROOT / "build" / "portbench_cache" / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "medvae_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer_metrics(run) -> dict:
    """The cell's per-layer metrics from their readers; a reader that finds
    nothing to read leaves its metric out."""
    from portbench.common import HERE, benchmark, end_to_end_names

    reported = set(end_to_end_names(run.name))
    out = {}
    for m in benchmark()["per_layer"]:
        cells = m.get("workloads")
        if (cells is not None and run.name not in cells) or (cells is None and m["moves"] not in reported):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", HERE / "metrics" / f"{m['name']}.py")
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def execute(cell: dict, seed: int, seconds: float, traced: bool, device: str, import_s: float = 0.0):
    """Set up, measure and check one run of `cell` on `device` ("cuda"; the
    tests drive it on "cpu" at a tiny size, untraced). Returns (the result
    object, (the checks, the other compared numbers))."""
    import torch

    from portbench import compare, trace
    from portbench.common import Run, benchmark, end_to_end_names, sync

    run = Run(cell, seed, seconds, traced, device)
    run.setup_parts["import_s"] = import_s
    driver = importlib.import_module(f"portbench.traffic.{cell['mix']['kind']}").Driver(run)
    cuda = device == "cuda"
    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - T_START
    print(f"portbench setup: {json.dumps({'setup_s': setup_s, **run.setup_parts})}", file=sys.stderr)

    if cuda:  # the window's peak: the set-up's own readings and copies are freed by now
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run.record.on = True
    with trace.traced(run, traced):
        driver.window(seconds)
    run.record.on = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if traced:
        run.flops_per_unit = driver.flops_per_unit()
        metrics = per_layer_metrics(run)
        out.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        breakdown = run.trace.breakdown(run.record.spans)
    else:
        values = dict(driver.end_to_end(), setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in benchmark()["end_to_end"]}
        metrics = {k: {"value": float(values[k]), "unit": units[k]} for k in end_to_end_names(run.name)
                   if k in values}
    print(f"portbench card: {card_line() if cuda else 'cpu'}; window {run.window_s:.3f} s; "
          f"work {json.dumps(run.work)}", file=sys.stderr)

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = driver.check()
    print(f"portbench check: the reference took {time.perf_counter() - t:.3f} s", file=sys.stderr)
    correct, checks = compare.judge(numbers, cell["mix"]["limits"])
    result = {"correct": bool(correct), "attempted": int(run.work.get("attempted", 0)),
              "failed": int(run.work.get("failed", 0)), "metrics": metrics, "device": out}
    if traced:
        result["breakdown"] = breakdown
    result["checks"] = {k: [v["value"], v["limit"]] for k, v in checks.items()}
    return result, (checks, {k: v for k, v in numbers.items() if k not in checks})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.common import CACHE, cell_spec

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    cell = cell_spec(args.workload)

    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    torch.cuda.init()
    try:
        import medvae_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port (medvae_tpu_torch) is not here: {e}", file=sys.stderr)
        return 3
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", import_s=time.perf_counter() - t)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port and its benchmark must not", file=sys.stderr)
        return 4
    from portbench import compare

    compare.print_checks(*checks)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
