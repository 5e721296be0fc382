"""The program's own spans and counters (`medvae_tpu_torch/core/tracing.py`)
in a traced window, for the metric readers.

The program records while a torch profiler records, so a `--trace 1` run
holds the spans of its window and an untraced run none. Spans are on the
host's `perf_counter_ns` clock, as `run.window_bounds` is; `run.trace.offset_ns`
maps them onto the device trace. Every reading is None where the program
recorded nothing to read (a program without the store, an untraced run), so
the metric is left out of the line.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def _store():
    try:
        from medvae_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing


def spans(run, name: str) -> List[tuple]:
    """The program's spans `name` that start inside the window: (id, name,
    start ns, end ns, parent id, ids) on the host's clock."""
    store, bounds = _store(), getattr(run, "window_bounds", None)
    if store is None or bounds is None:
        return []
    t0, t1 = bounds
    return [s for s in store.spans(name) if t0 <= s[2] < t1]


def host_ms(run, name: str) -> Optional[float]:
    """Host ms inside the window's spans `name`."""
    found = spans(run, name)
    return sum(s[3] - s[2] for s in found) / 1e6 if found else None


def device_ms(run, name: str) -> Optional[float]:
    """Device ms of the window's device spans `name` (their CUDA events;
    the window ends in a synchronize)."""
    store, found = _store(), spans(run, name)
    if not found:
        return None
    times = store.device_ms(name)
    got = [times[s[0]] for s in found if s[0] in times]
    return sum(got) if got else None


def counter(name: str) -> Optional[int]:
    store = _store()
    return None if store is None else store.counters().get(name)


def per(value: Optional[float], n) -> Optional[float]:
    return None if value is None or not n else value / n


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Where two sorted lists of disjoint intervals overlap."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_ms(run, inside: str, outside: Optional[str] = None) -> Optional[float]:
    """Device idle ms (the trace's idle gaps) in host time when a span
    `inside` was open and no span `outside` was."""
    found = spans(run, inside)
    if run.trace is None or not found:
        return None
    off = run.trace.offset_ns

    def cover(name_spans):
        return _union([(s[2] + off, s[3] + off) for s in name_spans])

    idle = _overlap(run.trace.idle_gaps(), cover(found))
    if outside is not None:
        held = _overlap(idle, cover(spans(run, outside)))
        return (sum(e - s for s, e in idle) - sum(e - s for s, e in held)) / 1e6
    return sum(e - s for s, e in idle) / 1e6
