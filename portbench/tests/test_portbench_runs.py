"""Whole runs of each cell at a tiny size on the CPU (tests/tiny.py): the
harness drives the port, then the plain reference, and decides `correct`.

* In fp32 the port and the frozen reference agree to rounding, under the
  committed limits: the reference is the port's plain math. (In bf16 at
  this size the gaps are wider than at the cells' own sizes on the card,
  where the limits were set.)
* The open-loop schedule is the seed's, each request timed from when it was
  due, the generator's lateness recorded.
* With the timed path broken underneath (a step that leaves the state
  unchanged, half of each batch left out, an answer altered where it is
  produced), `correct` comes out false against the committed limits.
"""

import numpy as np
import pytest

from portbench import run as run_mod
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 77  # wider than 32 signed bits, as a check's seeds may be
CELLS = ["flagship224.serve", "gan224.train", "gan224.eval"]


def execute(cell, seed=SEED, seconds=0.6):
    result, (checks, extra) = run_mod.execute(cell, seed, seconds, False, "cpu")
    return result, {**{k: v["value"] for k, v in checks.items()}, **extra}


@pytest.mark.parametrize("name", CELLS)
def test_fp32_port_agrees_with_reference(name):
    cell = tiny_cell(name)
    cell["model"]["precision"] = "fp32"
    result, numbers = execute(cell)
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    for key in ("grad_gap", "change_gap", "disc_change_gap", "recon_rel_l2", "psnr_gap_db", "metric_rel_gap"):
        if key in numbers:
            assert numbers[key] < 1e-4, (key, numbers[key])


@pytest.mark.parametrize("name", CELLS)
def test_bf16_run_result_line(name):
    """The port as configured (bf16): a whole run to its result line. The
    limits are set at the cells' own sizes on the card, so `correct` is not
    asserted at this tiny size, where bf16 rounds further from fp32."""
    result, numbers = execute(tiny_cell(name))
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v == v for v in numbers.values() if isinstance(v, float)), numbers
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


def test_open_loop_schedule_is_the_seeds():
    from portbench.common import Run
    from portbench.traffic.open_loop_serve import Driver

    def schedule(seed):
        drv = Driver(Run(tiny_cell("flagship224.serve"), seed, 1.0, False, "cpu"))
        drv.setup()
        out = (drv.due.copy(), drv.modality.copy(), drv.image_of.copy(), sorted(drv.sample))
        drv.batcher.close()
        return out

    a, b, c = schedule(SEED), schedule(SEED), schedule(SEED + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert len(a[0]) == len(c[0]) and np.bincount(a[1]).tolist() == np.bincount(c[1]).tolist()


def test_open_loop_times_from_due(monkeypatch):
    """A stalled engine: the requests due during the stall are late by it,
    though the generator sent them on time."""
    import time

    from medvae_tpu_torch.serve.engine import InferenceEngine

    inner = InferenceEngine.reconstruct
    stalled = []

    def slow(self, images, modality=None, output="float32"):
        if not stalled:
            stalled.append(True)
            time.sleep(0.3)
        return inner(self, images, modality=modality, output=output)

    from portbench.common import Run
    from portbench.traffic.open_loop_serve import Driver

    drv = Driver(Run(tiny_cell("flagship224.serve", rate_per_s=40.0), SEED, 1.0, False, "cpu"))
    drv.setup()
    monkeypatch.setattr(InferenceEngine, "reconstruct", slow)
    del drv.engine.reconstruct  # the set-up's wrapper, over the class's method
    drv._wrap_engine()
    drv.run.record.on = True
    drv.window(1.0)
    drv.batcher.close()
    assert np.max(drv.latency_s) >= 0.3  # the stall counts against the requests due in it
    assert np.percentile(drv.late_s, 95) < 0.1  # while the generator kept its schedule
    assert np.all(drv.latency_s > 0)
