"""The readers of the program's own spans (`portbench/program_spans.py`) on a
synthetic window: spans kept inside the window, host ms, device idle inside
one span and outside another on the trace's clock, and None where the
program recorded nothing."""

import time
from types import SimpleNamespace

import pytest

from medvae_tpu_torch.core import tracing
from portbench import program_spans
from portbench.trace import Trace


@pytest.fixture(autouse=True)
def clean_store():
    tracing.reset()
    tracing.enable(True)
    yield
    tracing.reset()
    tracing.enable(None)


def test_program_span_readers_on_a_synthetic_window():
    base = time.perf_counter_ns()
    for name, t0, t1 in (("batcher.batch", 100, 200), ("batcher.batch", 300, 400), ("engine.launch", 150, 180),
                         ("engine.launch", 320, 400), ("feed.gather", 50, 60), ("batcher.batch", 5000, 5100)):
        tracing.record(name, base + t0, base + t1)
    # the trace's clock runs 1000 ns ahead; busy (1100, 1120) and (1190, 1400)
    trace = Trace([("k", 1100, 1120), ("k", 1190, 1400)], 1000 - base, 1000, 1500)
    run = SimpleNamespace(window_bounds=(base, base + 500), trace=trace, work={"batches": 2})
    assert len(program_spans.spans(run, "batcher.batch")) == 2  # the third starts after the window
    assert program_spans.host_ms(run, "feed.gather") == pytest.approx(10e-6)
    # idle gaps (1000, 1100), (1120, 1190), (1400, 1500); the batches cover (1100, 1200) and (1300, 1400)
    # on the trace's clock, so only (1120, 1190) is idle inside one: 70 ns, of which the launch at
    # (1150, 1180) holds 30
    assert program_spans.idle_ms(run, "batcher.batch") == pytest.approx(70e-6)
    assert program_spans.idle_ms(run, "batcher.batch", "engine.launch") == pytest.approx(40e-6)
    assert program_spans.idle_ms(run, "feed.gather") == pytest.approx(10e-6)  # (1050, 1060)
    assert program_spans.host_ms(run, "engine.h2d") is None
    assert program_spans.idle_ms(run, "engine.h2d") is None
    assert program_spans.per(None, 3) is None and program_spans.per(6.0, 3) == 2.0
    assert program_spans.device_ms(run, "batcher.batch") is None  # host spans have no events
    assert program_spans.idle_ms(SimpleNamespace(window_bounds=run.window_bounds, trace=None),
                                 "batcher.batch") is None
