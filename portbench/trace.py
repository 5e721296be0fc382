"""The device trace of a measured window and its reduction.

`traced(run)` wraps the window in torch.profiler's CUDA activity (CUPTI
through Kineto) and leaves a `Trace` on the run: every device operation of
the window with its start and end, on the trace's clock, and the offset from
the host's `perf_counter_ns` clock to it, found from a marker kernel launched
right after a synchronize.

Copied pieces, frozen here so that later changes to the program's scripts do
not move the yardstick:
  * `_CATEGORIES` and `category` are chip_smoke.py's `_CATEGORIES` and
    `_category` (the kernel-name fragments of each layer), unchanged;
  * `device_events` reads the profiler's raw Kineto events as
    chip_smoke.py:device_kernels does (turning them into FunctionEvents
    takes tens of seconds for a window of 10^5 launches), but keeps each
    event's interval instead of summing durations.

Busy time is the union of the operations' intervals inside the window, so
operations that overlap count once.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from portbench.common import PEAK_BYTES_PER_S

# chip_smoke.py:_CATEGORIES, unchanged
_CATEGORIES = (
    ("attention_fwd_kernel", "attention_fwd (B4)"),  # the FMA instance
    ("attention_bwd_", "attention_bwd (B5)"),
    ("attention_rows_wgmma_kernel<true>", "attention_fwd (B4)"),  # the Hopper instance
    ("attention_rows_wgmma_kernelILb1E", "attention_fwd (B4)"),
    ("attention_rows_wgmma", "attention_bwd (B5)"),
    ("attention_cols_wgmma", "attention_bwd (B5)"),
    ("gn_fwd_", "gn_swish_fwd (B6)"),  # gn_fwd_resident, gn_fwd_cluster
    ("gn_row_stats", "gn_swish_fwd (B6)"),  # the streamed instance's three
    ("gn_group_stats", "gn_swish_fwd (B6)"),
    ("gn_swish_apply", "gn_swish_fwd (B6)"),
    ("gn_bwd", "gn_swish_bwd (B7)"),  # gn_bwd_{resident,cluster,reduce,row,apply}
    ("flash_fwd", "flash_fwd (B1)"),
    ("flash_planes_kernel", "flash_bwd (B2 + B3)"),  # the Hopper instance's two passes
    ("flash_grads_kernel", "flash_bwd (B2 + B3)"),
    ("Nhwc", "cudnn layout transforms"),
    ("Nchw", "cudnn layout transforms"),
    ("fprop", "convolution"),
    ("dgrad", "convolution"),  # cuDNN's implicit-GEMM backward kernels, whose
    ("wgrad", "convolution"),  # names hold "gemm" but not "conv"
    ("conv", "convolution"),
    ("gemm", "matmul"),
    ("group_norm", "group norm"),
    ("GroupNorm", "group norm"),
    ("softmax", "softmax"),
)
OTHER = "elementwise / copy / other"
# host seconds the trace runs before the window and after its last kernel:
# Kineto keeps an operation only where it lies inside the trace (chip_smoke's
# TRACE_PAD_S)
PAD_S = 0.25


def category(name: str) -> str:
    for frag, cat in _CATEGORIES:
        if frag in name:
            return cat
    return OTHER


def is_kernel(name: str) -> bool:
    """A kernel launch, not a copy or a fill the runtime issues."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Trace:
    """The window's device operations [(name, start ns, end ns)] on the
    trace's clock, the window's bounds on that clock, and `offset_ns`, the
    trace clock minus the host's perf_counter_ns clock."""

    def __init__(self, events: List[Tuple[str, int, int]], offset_ns: int, t0_ns: int, t1_ns: int):
        self.offset_ns = offset_ns
        self.t0, self.t1 = t0_ns, t1_ns
        self.events = sorted((e for e in events if e[2] > t0_ns and e[1] < t1_ns), key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self, fragments=None) -> List[Tuple[str, int, int]]:
        out = [e for e in self.events if is_kernel(e[0])]
        if fragments is not None:
            out = [e for e in out if any(f in e[0] for f in fragments)]
        return out

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in self.events:
            s, e = max(s, self.t0), min(e, self.t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            cat = category(name) if is_kernel(name) else "memcpy / memset"
            out[cat] = out.get(cat, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, last = [], self.t0
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.t1 > last:
            gaps.append((last, self.t1))
        return gaps

    def breakdown(self, spans) -> Dict[str, list]:
        """The ten device categories that took most time, and the ten
        longest idle gaps, each named by the innermost benchmark span open on
        the host at its middle ("no span" where none was)."""
        ops = sorted(self.seconds_by_category().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2 - self.offset_ns
            open_spans = [sp for sp in spans if sp[1] <= mid <= sp[2]]
            label = max(open_spans, key=lambda sp: sp[1])[0] if open_spans else "no span"
            named.append([label, (e - s) / 1e9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def device_events(prof) -> List[Tuple[str, int, int]]:
    """Every CUDA-device operation of a finished profile: (name, start ns,
    end ns), from the raw Kineto events."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


@contextlib.contextmanager
def traced(run, enabled: bool):
    """Trace the block's device work when `enabled` and leave `run.trace`.
    The block sets `run.window_bounds` to its window's (start, end) in host
    perf_counter_ns, synchronizing the card at the end."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros((1,), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        host_mark = time.perf_counter_ns()
        marker.add_(1.0)
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = device_events(prof)
    first = min(events, key=lambda e: e[1]) if events else None
    offset = (first[1] - host_mark) if first is not None else 0
    t0, t1 = run.window_bounds
    events = [e for e in events if e is not first]
    run.trace = Trace(events, offset, t0 + offset, t1 + offset)


def roofline_share(trace: Optional["Trace"], fragments, kernels_per_call: int, calls: list, work) -> Optional[float]:
    """Bound ms over device ms of a kernel's calls in the window: `calls`
    the shape of each call in order, `work(shape) -> (flops, bytes, peak
    flops)`; None where the trace holds none of them or not one event group
    per call."""
    if trace is None or not calls:
        return None
    events = trace.kernels(fragments)
    if not events or len(events) != kernels_per_call * len(calls):
        return None
    device_s = sum(e - s for _, s, e in events) / 1e9
    bound_s = 0.0
    for shape in calls:
        flops, nbytes, peak = work(shape)
        bound_s += max(flops / peak, nbytes / PEAK_BYTES_PER_S)
    return 100.0 * bound_s / device_s
