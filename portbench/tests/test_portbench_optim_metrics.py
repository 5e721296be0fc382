"""The readers of the optimizer's route and roofline (`optim_fused_share.train`,
`optimizer_roofline.train`) on a synthetic window, None where the program
counted nothing (as its parent, which has no such counters), and the
program's byte count held to the arithmetic the reader divides."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.train import optim
from portbench.common import HERE, PEAK_BYTES_PER_S

READERS = ("optim_fused_share.train", "optimizer_roofline.train")


@pytest.fixture(autouse=True)
def clean_store():
    tracing.reset()
    tracing.enable(True)
    yield
    tracing.reset()
    tracing.enable(None)


def _read(name, run):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", HERE / "metrics" / f"{name}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader.read(run)


def _section(run, device_ms):
    """One `step.optimizer` section inside a `step` span, its device ms set."""
    with tracing.span("step"):
        tracing.section("step.optimizer")
        tracing.section(None)
    sid = tracing.spans("step.optimizer")[-1][0]
    tracing._events[sid] = SimpleNamespace(elapsed_time=lambda end: device_ms), SimpleNamespace(query=lambda: True)
    return sid


def _run():
    return SimpleNamespace(trace=None, window_bounds=(0, 1 << 62), work={"steps": 2})


def test_readers_on_a_synthetic_window():
    run = _run()
    for ms in (10.0, 30.0):
        _section(run, ms)
    tracing.count("optim.fused", 3)
    tracing.count("optim.plain", 1)
    tracing.count("optim.least_bytes", 67_000_000_000)  # 20 ms at 3.35 TB/s
    assert _read("optim_fused_share.train", run) == pytest.approx(75.0)
    assert _read("optimizer_roofline.train", run) == pytest.approx(50.0)


def test_readers_find_nothing_without_the_counters():
    """The parent's program counts none of these: both readers leave their
    metric out, with or without the sections."""
    run = _run()
    assert [_read(name, run) for name in READERS] == [None, None]
    _section(run, 5.0)
    assert [_read(name, run) for name in READERS] == [None, None]
    tracing.count("optim.plain", 2)
    assert _read("optim_fused_share.train", run) == 0.0
    tracing.reset()
    tracing.count("optim.least_bytes", 100)
    assert _read("optimizer_roofline.train", run) is None  # no section timed


def test_program_counts_32_bytes_a_param_with_the_clip():
    """The GAN's AdamW with the clip: 32 B a param on either route (the
    reader's bound is these bytes over PEAK_BYTES_PER_S)."""
    tx = optim.build_optimizer({"type": "adamw", "lr": 1e-4, "weight_decay": 1e-5}, None, gradient_clip_val=1.0)
    params = [torch.zeros(3, 5), torch.zeros(7)]
    state = tx.init(params)
    tx.prepare(state)
    tx.apply_([torch.ones(3, 5), torch.ones(7)], state, params, torch.tensor(1.0))
    assert tracing.counters()["optim.least_bytes"] == 32 * 22
    assert 906_331_075 * 32 / PEAK_BYTES_PER_S * 1e3 == pytest.approx(8.66, abs=0.01)  # G's bound, ms
