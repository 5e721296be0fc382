"""The port's multirun sweeps against the JAX package's on the CPU: the sweep
grammar (`config/sweep.py`) on one table of override strings, exactly equal;
the sweep machinery of both `cli/train.py -m` on a two-by-two sweep with the
jobs' training stubbed out (the same job overrides, labels, statuses,
summary, run directories and printed table, and a failing job handled
alike); and one real job of a tiny BaseVAE through both, its val loss within
2e-4.

For the real job's numbers to be comparable the two packages must train the
same thing: the port's Trainer starts from the JAX Trainer's initial params
of the same job (`init_model_variables` recorded, `init_weights` replaced by
`from_jax_params` of them), both reparameterize with z = mean (the packages'
noise generators differ: the JAX PRNG and torch.Generator), and the run is
fp32, augment off, dropout 0, on the same synthetic split in the same
device-cached order (tests/test_torch_port_feeder.py).
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from medvae_tpu.cli import train as jax_cli
from medvae_tpu.config import sweep as jax_sweep
from medvae_tpu.models import base_vae as jax_base_vae
from medvae_tpu.train import trainer as jax_trainer
from medvae_tpu_torch.cli import train as port_cli
from medvae_tpu_torch.compat.jax_params import from_jax_params
from medvae_tpu_torch.config import sweep as port_sweep
from medvae_tpu_torch.models import base_vae as port_base_vae
from medvae_tpu_torch.train import trainer as port_trainer

VAL_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads (ROADMAP's test-time budget): the worker
    processes of the test runner share the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


OVERRIDES = [
    ["a=1,2,3"],
    ["a=1,2", "b=x,y"],
    ["model.ch_mult=[1,2,4]"],
    ["model.ch_mult=[1,2],[1,2,4]"],
    ["k=choice(1,2,3)"],
    ["k=choice([1,2],[3])"],
    ["k=range(3)"],
    ["k=range(1,10,3)"],
    ["k=range(0.1,0.5,0.1)"],
    ["k=range(5,0,-2)"],
    ["name=a\\,b"],
    ["name=a\\,b,c"],
    ["s='x,y'", "t=\"u,v\""],
    ["d={a:1,b:2}"],
    ["+training.limit_train_batches=2,4", "training.optimizer.lr=1e-3,2e-3", "seed=7"],
    ["experiment=chest_base_vae_quick", "noequals", "x=1,2"],
    ["  ", "x=1"],
    ["x="],
    ["fn=f(1,2)", "y=3,4"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=[" ".join(o) for o in OVERRIDES])
def test_sweep_grammar_matches_jax(overrides):
    """expand_multirun, sweep_values of each value and job_label of each job,
    exactly the JAX package's."""
    jobs, swept = port_sweep.expand_multirun(overrides)
    assert (jobs, swept) == jax_sweep.expand_multirun(overrides)
    for ov in overrides:
        if "=" in ov:
            raw = ov.split("=", 1)[1]
            assert port_sweep.sweep_values(raw) == jax_sweep.sweep_values(raw)
            assert port_sweep._split_top_level(raw) == jax_sweep._split_top_level(raw)
    assert [port_sweep.job_label(j, swept) for j in jobs] == [jax_sweep.job_label(j, swept) for j in jobs]


def test_range_errors_match_jax():
    for raw in ("range()", "range(1,2,3,4)", "range(1,5,0)"):
        with pytest.raises(ValueError) as want:
            jax_sweep.sweep_values(raw)
        with pytest.raises(ValueError) as got:
            port_sweep.sweep_values(raw)
        assert str(got.value) == str(want.value)


SWEEP = ["experiment=chest_base_vae_quick", "device=cpu", "precision=fp32", "training.max_epochs=1",
         "+training.limit_train_batches=2", "early_stopping.enabled=false", "data.batch_size=32",
         "model.hidden_channels=8", "model.ch_mult=[1,2]", "model.latent_dim=4", "model.dropout=0.0",
         "training.log_every_n_steps=100", "training.log_images_every_n_epochs=0", "training.val_check_interval=1.0",
         "seed=3"]
STUB_SWEEP = ["experiment=chest_base_vae_quick", "device=cpu", "training.optimizer.lr=1e-3,2e-3", "seed=3,4"]


def _summary(work):
    stamps = list((work / "logs" / "multirun").iterdir())
    assert len(stamps) == 1
    return stamps[0], json.loads((stamps[0] / "summary.json").read_text())


def _stubbed_sweep(cli, work, monkeypatch, capsys, fail_at=None):
    """`cli -m STUB_SWEEP` with its `_run_one` replaced by one that composes
    the job and writes its run directory (the CLI's own `_capture_run_dir`)
    and returns metrics made from the job's number, or raises at job
    `fail_at`: (each job's overrides, the summary without its seconds, the
    sweep directory's files, the printed lines), with the work directory and
    the stamp written as <work> and <stamp>."""
    calls = []

    def run_one(overrides):
        cli._capture_run_dir(cli.compose(cli.default_config_dir(), "config", overrides), overrides)
        calls.append(list(overrides))
        num = len(calls) - 1
        if num == fail_at:
            raise RuntimeError(f"job {num} failed")
        return {"val/loss": 0.5 + num / 8, "val/psnr": 20.0 - num}, {"test/loss": 0.75 + num / 8}

    monkeypatch.setattr(cli, "_run_one", run_one)
    capsys.readouterr()
    if fail_at is None:
        assert cli.main(["-m", *STUB_SWEEP, f"work_dir={work}"]) == 0
    else:
        with pytest.raises(RuntimeError, match=f"job {fail_at} failed"):
            cli.main(["-m", *STUB_SWEEP, f"work_dir={work}"])
    sweep_dir, summary = _summary(work)

    def plain(text):
        return text.replace(str(work), "<work>").replace(sweep_dir.name, "<stamp>")

    files = sorted(str(p.relative_to(sweep_dir)) for p in sweep_dir.rglob("*") if p.is_file())
    summary = [{k: v for k, v in r.items() if k != "seconds"} for r in summary]
    return (json.loads(plain(json.dumps(calls))), json.loads(plain(json.dumps(summary))), files,
            plain(capsys.readouterr().out).splitlines())


def test_two_job_sweep_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """The sweep machinery of both CLIs on a two-by-two sweep, each job's
    training stubbed out: the jobs' overrides and log_dirs, the labels,
    statuses and summary keys, the run directories and the printed table,
    all the JAX CLI's."""
    got = _stubbed_sweep(port_cli, tmp_path / "port", monkeypatch, capsys)
    want = _stubbed_sweep(jax_cli, tmp_path / "jax", monkeypatch, capsys)
    assert got == want
    calls, summary, files, printed = got
    assert [r["label"] for r in summary] == [f"training.optimizer.lr={lr},seed={seed}"
                                             for lr in ("1e-3", "2e-3") for seed in (3, 4)]
    assert [r["status"] for r in summary] == ["ok"] * 4 and calls[3][-1] == "log_dir=<work>/logs/multirun/<stamp>/3"
    assert "3/chest_base_vae_quick/config.yaml" in files and "summary.json" in files
    assert printed[-1] == "  [3] training.optimizer.lr=2e-3,seed=4: val/loss=0.87500"


def test_a_failing_job_stops_the_sweep_as_in_the_jax_cli(tmp_path, monkeypatch, capsys):
    """A job that raises: recorded with `status: error` and its error, the
    summary written, the exception raised again, the later jobs not run;
    the same as the JAX CLI."""
    got = _stubbed_sweep(port_cli, tmp_path / "port", monkeypatch, capsys, fail_at=1)
    assert got == _stubbed_sweep(jax_cli, tmp_path / "jax", monkeypatch, capsys, fail_at=1)
    assert [r["status"] for r in got[1]] == ["ok", "error"] and got[1][1]["error"] == "RuntimeError: job 1 failed"


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both CLIs' one-job sweeps, from the same initial params, z = mean."""
    jax_work, port_work = tmp_path_factory.mktemp("jax_sweep"), tmp_path_factory.mktemp("port_sweep")
    initial = []
    real_init = jax_trainer.init_model_variables

    def recording_init(*args, **kwargs):
        variables = real_init(*args, **kwargs)
        initial.append(jax.tree_util.tree_map(np.asarray, variables["params"]))  # before donation
        return variables

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "init_model_variables", recording_init)
        mp.setattr(jax_base_vae.BaseVAE, "reparameterize",
                   lambda self, mean, logvar, rng=None, noise=None: mean)
        t0 = time.perf_counter()
        assert jax_cli.main(["-m", *SWEEP, f"work_dir={jax_work}"]) == 0
        print(f"the JAX sweep: {time.perf_counter() - t0:.1f} s")  # mostly tracing and XLA
    assert len(initial) == 1
    queue = list(initial)

    def jax_weights(model, seed=0):
        params = queue.pop(0)
        model.load_state_dict(from_jax_params(params, model))
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_trainer, "init_weights", jax_weights)
        mp.setattr(port_base_vae.BaseVAE, "reparameterize",
                   staticmethod(lambda mean, logvar, noise=None, generator=None: mean))
        t0 = time.perf_counter()
        assert port_cli.main(["-m", *SWEEP, f"work_dir={port_work}"]) == 0
        print(f"the port's sweep: {time.perf_counter() - t0:.1f} s")
    return {"jax": _summary(jax_work), "port": _summary(port_work)}


def test_a_sweep_job_trains_as_the_jax_cli_job_does(sweeps):
    """One real job through each CLI's -m: the same keys, label and status,
    the val loss within 2e-4, the same run directory."""
    (jax_dir, want), (port_dir, got) = sweeps["jax"], sweeps["port"]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for key in ("job", "label", "status"):
            assert g[key] == w[key], key
        assert g["overrides"][:-1] == w["overrides"][:-1] and g["overrides"][-1].startswith("work_dir=")
        assert set(g["val"]) >= {"val/loss", "val/recon_loss", "val/kl_loss"}
        np.testing.assert_allclose(g["val"]["val/loss"], w["val"]["val/loss"], rtol=0, atol=VAL_TOL)
        assert sorted(g["val"]) == sorted(w["val"]) and sorted(g["test"]) == sorted(w["test"])
    assert [r["status"] for r in got] == ["ok"]
    assert sorted(p.name for p in (port_dir / "0").iterdir()) == sorted(p.name for p in (jax_dir / "0").iterdir())
    assert (port_dir / "0" / "checkpoints" / "chest_base_vae_quick" / "last").is_dir()


def test_a_failed_job_is_recorded_and_raised(tmp_path, capsys):
    """As the JAX CLI does: the failing job gets `status: error` and its
    error, the summary is still written, and the exception propagates."""
    with pytest.raises(ValueError, match="geometry mismatch"):
        port_cli.main(["-m", "experiment=chest_base_vae_quick", "device=cpu", f"work_dir={tmp_path}",
                       "model.ch_mult=[1,2,4,8],[1,2,2,2,2]"])
    _, summary = _summary(tmp_path)
    assert [r["status"] for r in summary] == ["error"]
    assert summary[0]["error"].startswith("ValueError: model/data geometry mismatch")
    assert set(summary[0]) == {"job", "overrides", "label", "status", "error", "seconds"}
