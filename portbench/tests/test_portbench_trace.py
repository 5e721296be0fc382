"""The yardstick's arithmetic: kernel rooflines against chip_smoke's counts,
and the trace's busy time as the union of intervals."""

import pytest

from portbench.roofline import flash_bwd, flash_fwd
from portbench.trace import Trace, roofline_share


def test_flash_fwd_counts_match_chip_smoke():
    flops, nbytes, peak = flash_fwd.work((32, 3136, 512))
    assert flops / 1e9 == pytest.approx(644.5, abs=0.05)
    assert nbytes / 1e6 == pytest.approx(411.0, abs=0.05)
    assert peak == 989e12


def test_flash_bwd_counts_match_chip_smoke():
    flops, nbytes, _ = flash_bwd.work((32, 3136, 512))
    assert flops / 1e9 == pytest.approx(1611.3, abs=0.05)
    assert nbytes == 7.0 * 32 * 3136 * 512 * 2 + 8.0 * 32 * 3136


def test_overlapping_intervals_count_once():
    events = [("a", 100, 200), ("b", 150, 250), ("c", 240, 260), ("d", 400, 500), ("e", 50, 90)]
    tr = Trace(events, offset_ns=0, t0_ns=80, t1_ns=480)
    # (80, 90) + (100, 260) + (400, 480): 10 + 160 + 80 ns of 400
    assert tr.busy_s() == pytest.approx(250e-9)
    assert [(s, e) for s, e in tr.idle_gaps()] == [(90, 100), (260, 400)]
    assert sum(e - s for _, s, e in tr.events) > 250  # summed durations would count overlaps twice


def test_idle_gap_named_by_open_span():
    # the trace's clock runs 1000 ns ahead of the host's
    tr = Trace([("k", 1100, 1200), ("k", 1600, 1700)], offset_ns=1000, t0_ns=1100, t1_ns=1700)
    spans = [("feed", 0, 500), ("step", 350, 450)]
    out = tr.breakdown(spans)
    # the one gap (1200, 1600) has its middle at 400 on the host: inside both spans, step the innermost
    assert out["idle_gaps"] == [["step", 400e-9]]
    assert out["device_ops"] == [["elementwise / copy / other", 200e-9]]


def test_roofline_share_needs_one_event_group_per_call():
    shape = (2, 3136, 512)
    flops, nbytes, peak = flash_bwd.work(shape)
    bound_ns = max(flops / peak, nbytes / 3.35e12) * 1e9
    events = [("flash_planes_kernel", 0, int(bound_ns)), ("flash_grads_kernel", int(bound_ns), int(4 * bound_ns))]
    tr = Trace(events, 0, 0, int(10 * bound_ns))
    share = roofline_share(tr, flash_bwd.FRAGMENTS, flash_bwd.KERNELS_PER_CALL, [shape], flash_bwd.work)
    assert share == pytest.approx(25.0, rel=1e-3)
    assert roofline_share(tr, flash_bwd.FRAGMENTS, 2, [shape, shape], flash_bwd.work) is None
    assert roofline_share(None, flash_bwd.FRAGMENTS, 2, [shape], flash_bwd.work) is None
