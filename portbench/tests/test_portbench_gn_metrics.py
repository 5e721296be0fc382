"""The readers of B6/B7's route and rooflines (`gn_fused_share.*`,
`gn_swish_fwd_roofline.serve`, `gn_swish_bwd_roofline.train`) on a synthetic
window, None where the program counted nothing, and the program's byte
arithmetic held to the frozen one of portbench/roofline/gn_swish.py."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.ops import groupnorm_swish as gs
from portbench.common import HERE, PEAK_BYTES_PER_S
from portbench.roofline import gn_swish
from portbench.trace import Trace

READERS = ("gn_fused_share.serve", "gn_fused_share.train", "gn_fused_share.eval",
           "gn_swish_fwd_roofline.serve", "gn_swish_bwd_roofline.train")


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


def _run():
    # the trace's clock equals the host's; B6 busy 4 µs (resident, then the
    # streamed instance's three kernels), B7 6 µs, a plain kernel between
    events = [("void gn_fwd_resident<__nv_bfloat16>(Args)", 1_000, 3_000),
              ("void gn_row_stats<float>(Args)", 3_000, 3_500), ("void gn_group_stats(Args)", 3_500, 4_000),
              ("void gn_swish_apply<float>(Args)", 4_000, 5_000),
              ("at::native::vectorized_elementwise_kernel", 5_000, 9_000),
              ("void gn_bwd_resident<__nv_bfloat16>(Args)", 9_000, 14_000), ("void gn_bwd_params(Args)", 14_000, 15_000)]
    return SimpleNamespace(trace=Trace(events, 0, 0, 20_000), window_bounds=(0, 20_000), work={})


def test_readers_on_a_synthetic_window():
    tracing.count("gn.fused", 97)
    tracing.count("gn.plain", 3)
    tracing.count("gn.fwd_bytes", 6_700_000)  # 2 µs at 3.35 TB/s
    tracing.count("gn.bwd_bytes", 16_750_000)  # 5 µs
    run = _run()
    for cell in ("serve", "train", "eval"):
        assert _read(f"gn_fused_share.{cell}", run) == pytest.approx(97.0)
    assert _read("gn_swish_fwd_roofline.serve", run) == pytest.approx(50.0)
    assert _read("gn_swish_bwd_roofline.train", run) == pytest.approx(5 / 6 * 100)


def test_readers_find_nothing_without_the_counters():
    """The parent's program counts none of these: every reader leaves its
    metric out, as it does without a trace."""
    run = _run()
    assert [_read(name, run) for name in READERS] == [None] * len(READERS)
    tracing.count("gn.plain", 5)
    tracing.count("gn.fwd_bytes", 100)
    assert _read("gn_fused_share.serve", run) == 0.0
    assert _read("gn_swish_fwd_roofline.serve", SimpleNamespace(trace=None)) is None
    assert _read("gn_swish_fwd_roofline.serve", SimpleNamespace(trace=Trace([], 0, 0, 10))) is None


def test_b6_b7_bytes_match_chip_smoke():
    # the 224² flagship's first level at bs 32 (PERF.md: B6 0.245 ms, B7 0.368 ms bound)
    shape = (32, 128, 224, 224)
    assert gn_swish.fwd_bytes(shape, 2, 32) / PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.245, abs=5e-4)
    assert gn_swish.bwd_bytes(shape, 2, 32) / PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.368, abs=5e-4)


@pytest.mark.parametrize("shape, dtype, groups", [((32, 128, 224, 224), torch.bfloat16, 32),
                                                  ((24, 512, 28, 28), torch.float32, 32),
                                                  ((3, 96, 5, 7), torch.bfloat16, 16)])
def test_program_counts_the_frozen_bytes(shape, dtype, groups):
    elem = torch.empty((), dtype=dtype).element_size()
    assert gs.min_bytes("gn_swish_fwd", shape, elem, groups) == gn_swish.fwd_bytes(shape, elem, groups)
    assert gs.min_bytes("gn_swish_bwd", shape, elem, groups) == gn_swish.bwd_bytes(shape, elem, groups)
