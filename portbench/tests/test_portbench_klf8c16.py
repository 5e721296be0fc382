"""The 1024² KL-f8 autoencoder's cell (`klf8c16_1024.eval`) at a tiny cut on
the CPU: a whole run in fp32 agrees with the frozen reference under the
committed limits, an altered reconstruction makes `correct` false, the fp8
control and swapped answers fail the limits, and the cell's new readers
read a synthetic window (and nothing where the program counts nothing, as
the parent's does not)."""

import copy
import importlib.util
from types import SimpleNamespace

import pytest

from medvae_tpu_torch.core import tracing
from portbench import run as run_mod
from portbench.common import HERE, cell_spec
from portbench.roofline import flash_fwd
from portbench.trace import Trace

SEED = 2**31 + 1024
CELL = "klf8c16_1024.eval"
# the cut: the configuration's pattern (1-2-4-4, the mid block's attention
# alone, latent 16, double_z) at hidden 16 and 32²
TINY = {"hidden_channels": 16, "resolution": 32}


def tiny_cell(**mix):
    cell = copy.deepcopy(cell_spec(CELL))
    cell["model"]["model"].update(TINY)
    cell["model"]["data"].update(size=32, batch_size=4)
    cell["model"]["precision"] = "fp32"
    cell["mix"].update({"split_rows": 64, "batches_sample": 2}, **mix)
    return cell


def execute(cell, seconds=0.5):
    result, (checks, extra) = run_mod.execute(cell, SEED, seconds, False, "cpu")
    return result, {**{k: v["value"] for k, v in checks.items()}, **extra}


def test_fp32_port_agrees_with_reference():
    result, numbers = execute(tiny_cell())
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"eval_img_per_s", "setup_s"}
    for key in ("recon_rel_l2", "psnr_gap_db", "metric_rel_gap"):
        assert numbers[key] < 1e-4, (key, numbers[key])


def test_evaluated_answer_altered(monkeypatch):
    import medvae_tpu_torch.cli.evaluate as evaluate

    inner = evaluate.eval_batch

    def altered(model, batch, noise=None, generator=None):
        m, x, rec, mean = inner(model, batch, noise=noise, generator=generator)
        return m, x, rec.roll(1, 0), mean

    monkeypatch.setattr(evaluate, "eval_batch", altered)
    result, numbers = execute(tiny_cell())
    assert not result["correct"] and numbers["recon_rel_l2"] > 0.5, numbers


def test_control_fails_the_limits_at_a_tiny_size():
    """The fp8 control and the swapped answers (portbench/control.py) fail
    the committed limits at the cut, as test_portbench_card.py holds the
    other cells (its tiny-size case has no cut of this configuration)."""
    import torch

    from portbench import control

    cell = tiny_cell()
    out = control.eval_control(cell, SEED, torch.device("cpu"))
    for kind, numbers in out.items():
        assert any(k in numbers and not numbers[k] <= limit for k, limit in cell["mix"]["limits"].items()), (kind, numbers)


def _read(name, run):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", HERE / "metrics" / f"{name}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader.read(run)


@pytest.fixture
def store():
    tracing.reset()
    tracing.enable(True)
    yield tracing
    tracing.reset()
    tracing.enable(None)


def test_readers_on_a_synthetic_window(store):
    """Three batches of the cell's two B1 sites at bs 8: six calls, each
    4.398 TFLOP (4.447 ms at the bf16 peak), against 60 ms of B1 kernels;
    the route counters of 6 flash and 2 plain attention calls, and of 49 + 1
    GroupNorm+SiLU site calls."""
    ms = 1_000_000
    events = [("void flash_fwd_wgmma<512>(Params)", i * 20 * ms, i * 20 * ms + 10 * ms) for i in range(6)]
    run = SimpleNamespace(cell=cell_spec(CELL), work={"batches": 3}, trace=Trace(events, 0, 0, 200 * ms),
                          window_bounds=(0, 200 * ms))
    bound_s = 6 * max(w / p for w, _, p in [flash_fwd.work((8, 16384, 512))])
    assert _read("flash_fwd_roofline.klf8c16", run) == pytest.approx(100.0 * bound_s / 0.060)
    assert _read("flash_fwd_roofline.klf8c16", SimpleNamespace(**{**vars(run), "work": {"batches": 2}})) is None
    assert _read("attn_flash_share.klf8c16", run) is None
    assert _read("gn_fused_share.klf8c16", run) is None
    store.count("attn.flash", 6)
    store.count("attn.plain", 2)
    store.count("gn.fused", 49)
    store.count("gn.plain", 1)
    assert _read("attn_flash_share.klf8c16", run) == pytest.approx(75.0)
    assert _read("gn_fused_share.klf8c16", run) == pytest.approx(98.0)
    assert _read("idle_share.klf8c16", run) == pytest.approx(70.0)
