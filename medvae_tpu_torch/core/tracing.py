"""The port's one store of spans and counters.

    with tracing.span("engine.h2d", bucket=8): ...      # a host interval
    with tracing.device_span("engine.launch"): ...       # and its device time
    tracing.record("batcher.queue", t0_ns, t1_ns, parent=batch_id, req=12)
    tracing.count("alloc.retries", 2)

A span is `(id, name, start ns, end ns, parent id, ids)` on the host's
`time.perf_counter_ns()` clock, the clock a profiler trace is mapped from
(portbench/trace.py finds the offset with a marker kernel), so every span
sits on the device timeline. `parent` defaults to the innermost span open on
the calling thread; `ids` (`req=`, `batch=`, ...) tie the spans of one
request or batch together.

`device_span` is a `span` that also records a pair of
`torch.cuda.Event(enable_timing=True)` on the current stream; `device_ms`
turns the pairs into device milliseconds after the caller has synchronized,
so nothing waits on them while work runs. On the CPU, or while the current
stream is being captured into a CUDA graph, it is a plain span. `section`
runs consecutive device spans on one thread, each ending where the next
begins (a train step's forward, backward, optimizer).

Recording is on while `enable(True)` was called, or, under the default
`enable(None)`, while a torch profiler records: `active()` reads the
profiler's module-wide flag, which every thread sees (the thread-local
`torch._C._autograd._profiler_enabled()` would leave the serving batcher's
thread silent). So a profiled window (portbench's `--trace 1`, the Trainer's
`debug.profile`) records spans, and an unprofiled run records none. When
off, `span` and `device_span` return one shared null context after one
global read.

Counters: `count(name, n)` adds to a named counter; the kernels' `launches`
dicts of ops/*.py `register` here under `launches.<kernel>`, keeping their
own locks and resets; `counters()` is one snapshot of both. Spans are kept in
memory, at most `MAX_SPANS` (the rest counted in `tracing.dropped`);
`reset()` clears spans and counters (not the kernels' launches), `export`
writes them as JSON.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 20

_NULL = contextlib.nullcontext()
_enabled: Optional[bool] = None
_spans: List[Tuple[int, str, int, int, Optional[int], Dict[str, Any]]] = []
_events: Dict[int, Tuple[Any, Any]] = {}  # device span id -> (start, end) CUDA events
_counters: Dict[str, int] = {}
_registered: Dict[int, Tuple[str, Dict[str, int], Any]] = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: the open span ids of a thread; .section: its open section


def enable(on: Optional[bool]) -> None:
    """True records always, False never, None (the default) while a torch
    profiler records."""
    global _enabled
    _enabled = on


def active() -> bool:
    if _enabled is None:
        # the module global profile._start_trace sets for every thread
        return _profiler._is_profiler_enabled
    return _enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(span: tuple) -> bool:
    if len(_spans) < MAX_SPANS:
        _spans.append(span)
        return True
    count("tracing.dropped")
    return False


class _Span:
    __slots__ = ("name", "parent", "ids", "device", "id", "t0", "start")

    def __init__(self, name: str, parent: Optional[int], ids: Dict[str, Any], device: bool):
        self.name, self.parent, self.ids, self.device = name, parent, ids, device

    def __enter__(self) -> int:
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(_ids)
        stack.append(self.id)
        self.start = None
        if self.device:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self.id

    def __exit__(self, *exc) -> bool:
        held = getattr(_local, "section", None)
        if held is not None and held is not self and held.parent == self.id:
            _end_section()
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        t1 = time.perf_counter_ns()
        stack = _stack()
        if self.id in stack:
            stack.remove(self.id)
        if _keep((self.id, self.name, self.t0, t1, self.parent, self.ids)) and end is not None:
            _events[self.id] = (self.start, end)
        return False


def _on_device() -> bool:
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


def span(name: str, parent: Optional[int] = None, **ids):
    """A host span around the block; `with ... as sid` gives its id (None
    when not recording)."""
    if not active():
        return _NULL
    return _Span(name, parent, ids, False)


def device_span(name: str, parent: Optional[int] = None, **ids):
    """A span that also times the block's work on the current stream."""
    if not active():
        return _NULL
    return _Span(name, parent, ids, _on_device())


def record(name: str, t0_ns: int, t1_ns: int, parent: Optional[int] = None, **ids) -> Optional[int]:
    """A span whose start was taken earlier (on perf_counter_ns); its id."""
    if not active():
        return None
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    sid = next(_ids)
    _keep((sid, name, int(t0_ns), int(t1_ns), parent, ids))
    return sid


def section(name: Optional[str], **ids) -> None:
    """End this thread's open section and open `name`, a device span under
    the innermost open span, which ends it on exit (with no span open, no
    section opens); the same name as the open one continues it, and None
    only ends it."""
    if not active():
        return
    held = getattr(_local, "section", None)
    if held is not None:
        if held.name == name:
            return
        _end_section()
    if name is not None and _stack():
        sec = _Span(name, None, ids, _on_device())
        sec.__enter__()
        _local.section = sec


def _end_section() -> None:
    sec = _local.section
    _local.section = None
    sec.__exit__(None, None, None)


def _done(ids=None) -> Dict[int, float]:
    """{span id: device ms} of the kept device spans (of `ids`) whose end
    event has completed; a span still in flight is left out."""
    return {sid: start.elapsed_time(end) for sid, (start, end) in list(_events.items())
            if (ids is None or sid in ids) and end.query()}


def device_ms(name: str) -> Dict[int, float]:
    """{span id: device ms} of the device spans named `name`, in the order
    they ended; call after synchronizing the device."""
    return _done({s[0] for s in _spans if s[1] == name})


def spans(name: Optional[str] = None) -> List[tuple]:
    """The kept spans (of `name`), in the order they ended."""
    return [s for s in _spans if name is None or s[1] == name]


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def register(prefix: str, counts: Dict[str, int], lock) -> None:
    """Report a module's own counter dict (kept under its own lock) in
    `counters()` as `<prefix>.<key>`."""
    _registered[id(counts)] = (prefix, counts, lock)


def counters() -> Dict[str, int]:
    with _count_lock:
        out = dict(_counters)
    for prefix, counts, lock in list(_registered.values()):
        with lock:
            out.update({f"{prefix}.{k}": v for k, v in counts.items()})
    return out


def reset() -> None:
    """Forget every span and the store's own counters."""
    _spans.clear()
    _events.clear()
    with _count_lock:
        _counters.clear()


def export(path: str) -> str:
    """Write the spans, their device ms where complete, and the counters as
    JSON; call after synchronizing the device."""
    done = _done()
    out = {"clock": "time.perf_counter_ns",
           "spans": [{"id": sid, "name": name, "start_ns": t0, "end_ns": t1, "parent": parent,
                      **({"device_ms": done[sid]} if sid in done else {}), **ids}
                     for sid, name, t0, t1, parent, ids in _spans],
           "counters": counters()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    return path
