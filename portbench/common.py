"""What every traffic driver shares: the cell's files, seeds, spans, counters,
the device's peak, and the run's record that the metric readers read.

A cell is one entry of BENCHMARK.json's `workloads`. Its configuration is
`portbench/configs/<config>.json`, its traffic mix
`portbench/workloads/<traffic>.json`, whose `kind` names the driver
`portbench/traffic/<kind>.py`. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout
CACHE = ROOT / "build" / "portbench_cache"  # every build and kernel cache of a run, at fixed paths

# published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str) -> Dict[str, Any]:
    """The cell `name` of BENCHMARK.json with its configuration and traffic
    mix read from their files: {"name", "chips", "config", "traffic",
    "model": config file, "mix": traffic file}."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = dict(cells[name])
    cfgs = {c["name"]: c for c in bench["configs"]}
    cell["model"] = load_json(ROOT / cfgs[cell["config"]]["file"])
    cell["mix"] = load_json(HERE / "workloads" / f"{cell['traffic']}.json")
    return cell


def end_to_end_names(cell: str) -> List[str]:
    """The end-to-end metrics the cell reports."""
    return [m["name"] for m in benchmark()["end_to_end"] if cell in m.get("workloads", [cell])]


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream (weights, data, noise, ...) of a
    run's `--seed`; any whole number up to 2**63 in, 63 bits out."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9) % (1 << 64)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) % (1 << 64)
    return (x ^ (x >> 29)) % (1 << 63)


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Record:
    """Spans and counters a run records around its calls into the program's
    layers, on the host's `time.perf_counter_ns` clock; read by the metric
    readers after the window."""

    def __init__(self):
        self.spans: List[tuple] = []  # (name, start ns, end ns)
        self.counters: Dict[str, Any] = {}
        self.on = False  # spans are kept only inside the measured window

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def span_seconds(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name) / 1e9


class Run:
    """What one run measured, handed to the metric readers: the cell, the
    window's host seconds, the work done in it, the record, the trace
    (`trace.Trace` or None) and the model FLOPs the cell declares."""

    def __init__(self, cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str = "cuda"):
        self.cell, self.seed, self.seconds, self.traced, self.device = cell, seed, seconds, trace, device
        self.record = Record()
        self.window_s: float = 0.0
        self.work: Dict[str, float] = {}  # "steps", "images", "requests", ...
        self.trace = None  # trace.Trace of the window when traced
        self.flops_per_unit: Optional[float] = None  # the reference's FLOPs a step or an image
        self.kernel_calls: Dict[str, list] = {}  # kernel -> the (b, n, c) of each call in the window
        self.setup_parts: Dict[str, float] = {}

    @property
    def name(self) -> str:
        return self.cell["name"]
