"""The port's Trainer and `cli/train.py` on the CPU (the JAX Trainer is not
run here): resume bitwise, the monitor state, the fail-fast checks, and the
quick experiment end to end through the CLI with its media grids written
and its final checkpoint served; the GAN quick experiment through the CLI
past its discriminator gate, resumed bit for bit (the discriminator's
params, BatchNorm statistics and optimizer state included), its checkpoint
loaded by `load_model`. Models are shrunk (hidden 8, ch_mult [1, 2],
latent 4) to keep the file near a minute. The data, feeder, metrics,
eval-step and compose tests are in tests/test_torch_port_data.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from medvae_tpu_torch.cli import train as cli_train
from medvae_tpu_torch.cli.common import load_model
from medvae_tpu_torch.config.compose import compose
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.serve.engine import InferenceEngine
from medvae_tpu_torch.train import trainer as ttrainer
from medvae_tpu_torch.train.trainer import Trainer
from medvae_tpu_torch.utils.visualization import read_png_size

TINY = ["model.hidden_channels=8", "model.ch_mult=[1,2]", "model.latent_dim=4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------- trainer ---- #


def _cfg(config_dir, work, max_epochs, extra=()):
    return compose(config_dir, "config", [
        "experiment=chest_base_vae_quick", f"work_dir={work}", "device=cpu",
        f"training.max_epochs={max_epochs}", "training.log_every_n_steps=100",
        "early_stopping.enabled=false", "data.batch_size=128", "+training.limit_train_batches=4",
        *TINY, *extra,
    ])


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


def test_resume_is_exact(tmp_path, config_dir):
    """Interrupted at an epoch boundary and resumed from `last`, the run ends
    with the uninterrupted run's params bit for bit (dropout 0.1 included)."""
    full = Trainer(_cfg(config_dir, tmp_path / "full", 2))
    full.fit()
    assert full.state.step == 8
    first = Trainer(_cfg(config_dir, tmp_path / "split", 1))
    first.fit()
    resumed = Trainer(_cfg(config_dir, tmp_path / "split", 2, ["resume=true"]))
    assert resumed.state.step == 4
    resumed.fit()
    want, got = _params(full), _params(resumed)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(full.state.opt_state.nu, resumed.state.opt_state.nu):
        assert torch.equal(a, b)


def test_resume_mid_epoch_skips_consumed_batches(tmp_path, config_dir):
    """A state restored at step 3 of an epoch trains the epoch's remaining
    steps, and every_n_steps refreshes `last` within the epoch."""
    t = Trainer(_cfg(config_dir, tmp_path, 1, ["+checkpointing.every_n_steps=3"]))
    t.state.step = 3
    t.fit()
    assert t.state.step == 4
    assert os.path.isfile(os.path.join(t.ckpt.directory, "last", "checkpoint.pt"))


def test_mid_epoch_validation_and_top_k_zero(tmp_path, config_dir):
    """val_check_interval 0.25 validates after a quarter of the epoch's 16
    steps (step 4); save_top_k 0 keeps no best snapshot, only `last`."""
    t = Trainer(_cfg(config_dir, tmp_path, 1, ["training.val_check_interval=0.25",
                                               "checkpointing.save_top_k=0"]))
    t.fit()
    with open(os.path.join(t.logger.dir, "metrics.jsonl")) as f:
        val_steps = [row["step"] for row in map(json.loads, f) if "val/loss" in row]
    assert val_steps == [4, 16]
    assert sorted(os.listdir(t.ckpt.directory)) == ["chest_base_vae_quick_final", "config.yaml", "last"]


def test_resume_restores_monitor_state(tmp_path, config_dir):
    extra = ["training.scheduler.type=plateau", "+training.scheduler.patience=50",
             "early_stopping.enabled=true", "early_stopping.patience=50"]
    t1 = Trainer(_cfg(config_dir, tmp_path, 1, extra))
    t1.fit()
    assert t1.early_stopping.best is not None and t1._plateau["best"] is not None
    t2 = Trainer(_cfg(config_dir, tmp_path, 2, extra + ["resume=true"]))
    assert t2.early_stopping.best == t1.early_stopping.best
    assert t2.early_stopping.counter == t1.early_stopping.counter
    assert t2._plateau == t1._plateau
    assert t2.state.lr_scale == t1.state.lr_scale


def test_trainer_rejects_unknown_monitor(tmp_path, config_dir):
    t = Trainer(_cfg(config_dir, tmp_path, 1, ["early_stopping.enabled=true",
                                               "early_stopping.monitor=val/does_not_exist"]))
    with pytest.raises(ValueError, match="does_not_exist"):
        t.fit()


def test_trainer_rejects_geometry_mismatch(tmp_path, config_dir):
    with pytest.raises(ValueError, match="geometry mismatch"):
        Trainer(_cfg(config_dir, tmp_path, 1, ["model.ch_mult=[1,2,4,8]"]))
    assert ttrainer.decoded_size(28, 3) == 24 and ttrainer.decoded_size(128, 3) == 128


@pytest.mark.parametrize("override", [
    "debug.nan_checks=true", "mesh.data=2", "debug.profile=true", "+parallel.explicit_shard_map=true",
])
def test_trainer_names_what_is_not_ported(tmp_path, config_dir, override):
    """Nothing of these is refused as unported any more: the debug options
    and parallel.explicit_shard_map are taken (their runs:
    tests/test_torch_port_runs.py, tests/test_torch_port_mesh.py), and a mesh
    larger than the one process raises JAX's ValueError, as on one device."""
    if override == "mesh.data=2":
        with pytest.raises(ValueError, match="does not tile 1 devices"):
            Trainer(_cfg(config_dir, tmp_path, 1, [override]))
        return
    t = Trainer(_cfg(config_dir, tmp_path, 1, [override]))
    if override.startswith("debug."):
        assert t._debug(override.split("=")[0].split(".")[1])
    else:
        assert t._explicit_sm and t.mesh.shape == {"data": 1, "model": 1}


def test_trainer_asks_for_the_card_and_raises_without_one(tmp_path, config_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("tpu", "cuda", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.resolve_device(name)
    assert ttrainer.resolve_device("cpu") == torch.device("cpu")


def test_cli_trains_the_quick_experiment_and_serves_its_final_checkpoint(tmp_path, capsys):
    assert cli_train.main([
        "experiment=chest_base_vae_quick", "device=cpu", f"work_dir={tmp_path}",
        "training.max_epochs=2", "training.log_every_n_steps=1", "early_stopping.enabled=false",
        "+training.limit_train_batches=2", "data.batch_size=64", "checkpointing.save_top_k=1", *TINY,
    ]) == 0
    out = capsys.readouterr().out
    assert "Final checkpoint" in out and "val/psnr" in out and "test/loss" in out
    root = tmp_path / "logs" / "checkpoints" / "chest_base_vae_quick"
    best = [d for d in os.listdir(root) if d.startswith("step_")]
    assert len(best) == 1 and os.path.isfile(root / "last" / "checkpoint.pt")
    assert (root / "config.yaml").exists() and (root / "index.json").exists()
    run = tmp_path / "logs" / "chest_base_vae_quick"
    for name in ("config.yaml", "overrides.yaml", "metrics.jsonl", "hparams.yaml"):
        assert (run / name).exists(), name
    # media every 10 epochs, epoch 0 included: 8 validation images over their
    # reconstructions, and 16 prior samples 4 x 4, 28² tiles 2 px apart
    assert sorted(os.listdir(run / "media")) == ["epoch_0000_recon.png", "epoch_0000_samples.png"]
    assert read_png_size(str(run / "media" / "epoch_0000_recon.png")) == (8 * 30 + 2, 2 * 30 + 2)
    assert read_png_size(str(run / "media" / "epoch_0000_samples.png")) == (4 * 30 + 2, 4 * 30 + 2)
    final = str(root / "chest_base_vae_quick_final")
    model = load_model(final, "cpu")
    assert not model.training
    images = np.random.RandomState(0).randint(0, 256, (3, 28, 28, 1), np.uint8)
    rec = InferenceEngine(model, buckets=(4,), device="cpu").reconstruct(images)
    assert rec.shape == (3, 28, 28, 1) and np.isfinite(rec).all()


# two of the experiment's five datasets (one gray, one RGB): each validation
# and test pass runs 512 images through LPIPS and D instead of 1280
GAN_TINY = ["experiment=multi_modal_cvae_gan_quick", "device=cpu", "model.hidden_channels=8",
            "model.latent_dim=4", "model.ch_mult=[1,2]", "data.batch_size=128",
            "data.dataset_names=[chestmnist,pathmnist]",
            "+training.limit_train_batches=3", "training.loss.discriminator_iter_start=2",
            "training.log_every_n_steps=1", "early_stopping.enabled=false"]


def test_gan_trains_past_the_gate_through_the_cli_and_resumes_bit_for_bit(tmp_path, config_dir, capsys):
    """cli/train.py on the GAN quick experiment (gate at step 2 of the first
    epoch's 3, dropout 0.1, so the adaptive weight takes its own decoder
    pass): one epoch, then resume=true to two, against two epochs
    uninterrupted; then the final checkpoint loads through `load_model`."""
    split = [*GAN_TINY, f"work_dir={tmp_path / 'split'}"]
    assert cli_train.main([*split, "training.max_epochs=1"]) == 0
    assert cli_train.main([*split, "training.max_epochs=2", "resume=true"]) == 0
    out = capsys.readouterr().out
    assert "Resuming at optimizer step 3" in out and "Final checkpoint" in out
    with open(tmp_path / "split" / "logs" / "multi_modal_cvae_gan_quick" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in sorted(rows, key=lambda r: r["step"]) if "train/d_weight" in r]
    assert [r["train/d_weight"] > 0 and r["train/d_loss"] > 0 for r in train] == [False, False] + [True] * 4
    assert all(np.isfinite(v) for r in train for k, v in r.items() if k.startswith("train/"))
    assert any("val/d_loss" in r for r in rows)
    whole = Trainer(compose(config_dir, "config", [*GAN_TINY, f"work_dir={tmp_path / 'whole'}",
                                                    "training.max_epochs=2"]))
    whole.fit()
    root = tmp_path / "split" / "logs" / "checkpoints" / "multi_modal_cvae_gan_quick"
    resumed = Trainer(compose(config_dir, "config", [*GAN_TINY, f"work_dir={tmp_path / 'split'}",
                                                      "training.max_epochs=2", "resume=true"]))
    assert resumed.state.step == whole.state.step == 6
    want, got = whole.state, resumed.state
    for mine, theirs in ((got.params, want.params), (got.disc_params, want.disc_params),
                         (got.disc_batch_stats, want.disc_batch_stats)):
        assert set(mine) == set(theirs)
        for k in theirs:
            assert torch.equal(mine[k], theirs[k]), k
    for a, b in zip(got.disc_opt_state.mu + got.disc_opt_state.nu,
                    want.disc_opt_state.mu + want.disc_opt_state.nu):
        assert torch.equal(a, b)
    assert got.disc_opt_state.count == want.disc_opt_state.count == 6
    model = load_model(str(root / "multi_modal_cvae_gan_quick_final"), "cpu")
    assert not model.training and type(model).__name__ == "ConditionalVAE"
    served = model.state_dict()  # the generator alone, conv weights stored in bf16 to serve
    assert set(served) == set(want.params)
    assert all(torch.equal(served[k], v.to(served[k].dtype)) for k, v in want.params.items())


def test_trainer_takes_both_gan_experiments_and_refuses_an_empty_logit_map(tmp_path, config_dir):
    """Neither GAN experiment is refused as unported; the full-width one's
    ConditionalVAE has 906.3 M params (counted on the meta device); a 16²
    image leaves the default three-layer discriminator no logits."""
    for experiment in ("multi_modal_cvae", "multi_modal_cvae_gan_quick"):
        cfg = compose(config_dir, "config", [f"experiment={experiment}", "device=cpu"])
        assert ttrainer.resolve_mesh(cfg, torch.device("cpu")).shape == {"data": 1, "model": 1}
        assert cfg["training"]["loss"]["type"] == "lpips_discriminator"
    full = compose(config_dir, "config", ["experiment=multi_modal_cvae"])
    model = build_model(full["model"], "bf16", "meta", train=True)
    assert sum(p.numel() for p in model.parameters()) == 906_331_075
    with pytest.raises(ValueError, match="empty logit map"):
        Trainer(compose(config_dir, "config", ["experiment=multi_modal_cvae_gan_quick", "device=cpu",
                                               f"work_dir={tmp_path}", "data.size=16", *TINY]))
