"""A run with the timed path broken underneath comes out not correct, against
the committed limits: each fault the cells can have, planted in the port at
a tiny size on the CPU, with the port in fp32 so that a sound run reads its
gaps at rounding (tests/test_portbench_runs.py)."""

import numpy as np
import pytest

from portbench import run as run_mod
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 909


def run_tiny(name):
    cell = tiny_cell(name)
    cell["model"]["precision"] = "fp32"
    result, (checks, _) = run_mod.execute(cell, SEED, 0.5, False, "cpu")
    return result["correct"], {k: v["value"] for k, v in checks.items()}


@pytest.mark.parametrize("name", ["gan224.train"])
def test_step_that_leaves_the_state_unchanged(monkeypatch, name):
    import medvae_tpu_torch.train.step as step

    monkeypatch.setattr(step, "_apply", lambda params, updates, lr_scale: None)
    correct, numbers = run_tiny(name)
    assert not correct and numbers["change_gap"] > 0.9 and numbers["disc_change_gap"] > 0.9, numbers


@pytest.mark.parametrize("name", ["gan224.train"])
def test_half_of_each_batch_left_out(monkeypatch, name):
    from medvae_tpu_torch.train.step import TrainStep

    inner = TrainStep.run

    def half(self, state, batch, generator=None, draws=None):
        n = batch["image_u8"].shape[0] // 2
        batch = {k: v[:n] for k, v in batch.items()}
        draws = None if draws is None else {k: v[:n] for k, v in draws.items()}
        return inner(self, state, batch, generator, draws)

    monkeypatch.setattr(TrainStep, "run", half)
    correct, numbers = run_tiny(name)
    assert not correct, numbers


def test_served_answer_altered(monkeypatch):
    from medvae_tpu_torch.serve.engine import InferenceEngine

    inner = InferenceEngine.reconstruct

    def altered(self, images, modality=None, output="float32"):
        out = inner(self, images, modality=modality, output=output)
        return np.roll(out, 1, axis=0) if len(out) > 1 else -out

    monkeypatch.setattr(InferenceEngine, "reconstruct", altered)
    correct, numbers = run_tiny("flagship224.serve")
    assert not correct and numbers["recon_rel_l2"] > 0.5, numbers


def test_evaluated_answer_altered(monkeypatch):
    import medvae_tpu_torch.cli.evaluate as evaluate

    inner = evaluate.eval_batch

    def altered(model, batch, noise=None, generator=None):
        m, x, rec, mean = inner(model, batch, noise=noise, generator=generator)
        return m, x, rec.roll(1, 0), mean

    monkeypatch.setattr(evaluate, "eval_batch", altered)
    correct, numbers = run_tiny("gan224.eval")
    assert not correct and numbers["recon_rel_l2"] > 0.5, numbers
