"""The port's training stack on the CPU: dropout, data, feeder, metrics, the
eval step, config composition, checkpoints, the Trainer and `cli/train.py`.

Against the JAX package, with inputs from numpy seeds: the synthetic MedMNIST
splits and the feeder's batches (shuffled, stratified, eval-padded, over two
epochs) bitwise; the metrics 1e-5; the eval step of each model family 2e-4
(absolute, and relative for PSNR and the KL totals, which are tens to
thousands); `compose` equal as plain dicts. The Trainer is the port's alone
(the JAX Trainer is not run here): resume bitwise, the monitor state, the
fail-fast checks, and the quick experiment end to end through the CLI with
its final checkpoint served; the GAN quick experiment through the CLI past
its discriminator gate, resumed bit for bit (the discriminator's params,
BatchNorm statistics and optimizer state included), its checkpoint loaded
by `load_model`. Models are shrunk (hidden 8, ch_mult [1, 2],
latent 4) to keep the file near a minute.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu.config import compose as jax_compose
from medvae_tpu.data import medmnist as jmed
from medvae_tpu.data import pipeline as jpipe
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.train import metrics as jmetrics
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu_torch.cli import train as cli_train
from medvae_tpu_torch.cli.common import load_model
from medvae_tpu_torch.compat.jax_params import from_jax_params
from medvae_tpu_torch.config.compose import compose
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.data import medmnist as tmed
from medvae_tpu_torch.data import pipeline as tpipe
from medvae_tpu_torch.nn.blocks import ResnetBlock, dropout
from medvae_tpu_torch.serve.engine import InferenceEngine
from medvae_tpu_torch.train import metrics as tmetrics
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep
from medvae_tpu_torch.train import trainer as ttrainer
from medvae_tpu_torch.train.optim import build_optimizer
from medvae_tpu_torch.train.trainer import Trainer

TINY = ["model.hidden_channels=8", "model.ch_mult=[1,2]", "model.latent_dim=4"]

# ------------------------------------------------------------- dropout ---- #


def test_dropout_keeps_one_minus_rate_and_scales_the_kept():
    x = torch.full((200, 100), 3.0)
    out = dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 3.0 / 0.75))
    again = dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)  # the step's generator fixes the masks


def test_resnet_block_drops_in_train_mode_only():
    block = ResnetBlock(16, 16, dropout=0.5)
    plain = ResnetBlock(16, 16)
    plain.load_state_dict(block.state_dict())
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        train_out = block.train()(x, gen)
        block.eval()
        torch.testing.assert_close(block(x, gen), plain.eval()(x), rtol=0, atol=0)
    assert not torch.allclose(train_out, plain(x))


def test_model_configs_take_dropout_and_eval_turns_it_off():
    cfg = {"_target_": "medvae_tpu.models.BaseVAE", "input_channels": 1, "latent_dim": 4,
           "hidden_channels": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [],
           "resolution": 16, "dropout": 0.1}
    served = build_model(cfg, "fp32", "cpu")
    rates = {m.dropout for m in served.modules() if isinstance(m, ResnetBlock)}
    assert rates == {0.1} and not served.training
    trained = build_model(cfg, "fp32", "cpu", train=True)
    assert trained.training


# ---------------------------------------------------------------- data ---- #


@pytest.mark.parametrize("name, split, size", [("chestmnist", "train", 28), ("pathmnist", "val", 28),
                                               ("chestmnist", "val", 128)])
def test_synthetic_split_is_the_jax_one_bit_for_bit(name, split, size):
    want = jmed._synthetic_split(name, split, size, seed=0)
    got = tmed._synthetic_split(name, split, size, seed=0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_datamodule_splits_match_jax(tmp_path):
    kwargs = dict(dataset_names=["chestmnist", "pathmnist"], batch_size=8, size=28,
                  root=str(tmp_path))
    want, got = jmed.MedMNISTDataModule(**kwargs), tmed.MedMNISTDataModule(**kwargs)
    for split in ("train", "val", "test"):
        a, b = got.split(split), want.split(split)
        for field in ("images", "labels", "modality_idx"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), (split, field)
    assert got.max_channels == want.max_channels == 3
    assert got.synthetic_banner() == want.synthetic_banner()


def test_synthetic_cache_lies_in_the_ports_own_directory(tmp_path):
    images, _ = tmed._synthetic_split_cached("chestmnist", "val", 112, 0, str(tmp_path))
    assert os.listdir(tmp_path) == ["_synth_cache_torch"]
    again, _ = tmed._synthetic_split_cached("chestmnist", "val", 112, 0, str(tmp_path))
    assert np.array_equal(images, again)


@pytest.mark.parametrize("shuffle, stratify, drop_last", [(True, False, True), (True, True, True),
                                                          (False, False, False)])
def test_feeder_batches_are_the_jax_feeders_bit_for_bit(tmp_path, shuffle, stratify, drop_last):
    dm = jmed.MedMNISTDataModule(["chestmnist", "pathmnist"], size=28, root=str(tmp_path))
    arrays = dm.split("val")  # 512 samples, two modalities: bs 96 leaves a tail
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = jpipe.DeviceFeeder(arrays, 96, mesh, shuffle=shuffle, drop_last=drop_last, seed=3,
                             stratify=stratify)
    port = tpipe.DeviceFeeder(tmed.SplitArrays(**vars(arrays)), 96, "cpu", shuffle=shuffle,
                              drop_last=drop_last, seed=3, stratify=stratify)
    assert port.steps_per_epoch == ref.steps_per_epoch
    for epoch in (0, 1):
        want, got = list(ref.epoch(epoch)), list(port.epoch(epoch))
        assert len(got) == len(want) == ref.steps_per_epoch
        for b_got, b_want in zip(got, want):
            assert set(b_got) == set(b_want)
            for k in b_want:
                assert np.array_equal(b_got[k].numpy(), np.asarray(b_want[k])), (epoch, k)
    if not drop_last:
        assert got[-1]["valid"].sum().item() == 512 - 5 * 96


# ------------------------------------------------------------- metrics ---- #


def _pair(seed, shape=(5, 20, 20, 3)):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-1, 1, shape).astype(np.float32)
    return a, np.clip(a + 0.2 * rs.randn(*shape).astype(np.float32), -1, 1)


def test_metrics_match_jax():
    pred, target = _pair(0)
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    rs = np.random.RandomState(1)
    mean, logvar, z = (rs.randn(5, 4, 4, 6).astype(np.float32) for _ in range(3))
    want = {**jmetrics.reconstruction_metrics(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid)),
            **jmetrics.kl_metrics(jnp.asarray(mean), jnp.asarray(logvar), jnp.asarray(valid)),
            **jmetrics.latent_metrics(jnp.asarray(z), jnp.asarray(valid))}
    t = torch.from_numpy
    got = {**tmetrics.reconstruction_metrics(t(pred), t(target), t(valid)),
           **tmetrics.kl_metrics(t(mean), t(logvar), t(valid)),
           **tmetrics.latent_metrics(t(z), t(valid))}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tmetrics.ssim(t(pred), t(target)).numpy(),
                               np.asarray(jmetrics.ssim(jnp.asarray(pred), jnp.asarray(target))),
                               atol=1e-5)


# ----------------------------------------------------------- eval step ---- #

CODEC = dict(hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=16)
FAMILIES = {
    "BaseVAE": (JaxBaseVAE, dict(CODEC, input_channels=3, latent_dim=4), {"type": "vae"}),
    "ConditionalVAE": (JaxCVAE, dict(CODEC, input_channels=3, latent_dim=4), {"type": "vae"}),
    "DisentangledConditionalVAE": (
        JaxDCVAE, dict(CODEC, num_modalities=5, shared_latent_dim=4, modality_latent_dim=4),
        {"type": "disentangled_vae", "separation_weight": 0.1, "contrastive_weight": 0.2}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_step_matches_jax(family):
    cls, arch, loss = FAMILIES[family]
    b = 6
    rs = np.random.RandomState(4)
    midx = np.array([0, 1, 2, 3, 4, 1], np.int32)
    batch = {
        "image_u8": rs.randint(0, 256, (b, 16, 16, 3)).astype(np.uint8),
        "modality_idx": midx,
        "modality_onehot": np.eye(12, dtype=np.float32)[midx],
        "channels": np.array([1, 3, 3, 1, 3, 3], np.int32),
        "valid": np.array([1, 1, 1, 1, 0, 1], np.float32),
        "noise": rs.randn(b, 8, 8, 8 if family.startswith("Dis") else 4).astype(np.float32),
    }
    jm = cls(**arch)
    args = [jnp.zeros((2, 16, 16, 3))]
    if cls is JaxCVAE:
        args.append(jnp.zeros((2, 12)))
    if cls is JaxDCVAE:
        args.append(jnp.zeros((2,), jnp.int32))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              *args)["params"]
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeval = jstep.build_eval_step(jm, loss, mesh, max_channels=3)
    want = jeval(jstate.create_train_state(params, optax.sgd(0.1)),
                 {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    model = build_model(dict(arch, _target_=family), "fp32", "cpu", train=True)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    state = tstate.create_train_state(model, build_optimizer({"type": "adam"}))
    got = tstep.build_eval_step(model, loss, max_channels=3)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert model.training  # the step turns eval mode on and back off
    assert set(got) == set(want) and ("val/_zmod_sum_by_mod" in got) == family.startswith("Dis")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-4, err_msg=k)


# -------------------------------------------------------------- config ---- #


@pytest.mark.parametrize("overrides", [
    ["experiment=chest_base_vae", "model.resolution=128", "data.size=128"],
    ["experiment=chest_base_vae_quick", "device=cpu", "+training.limit_train_batches=8"],
])
def test_compose_equals_the_jax_compose(config_dir, overrides):
    want = jax_compose(config_dir, "config", overrides).to_dict()
    got = compose(config_dir, "config", overrides).to_dict()
    assert got == want
    assert got["model"]["_target_"] == "medvae_tpu.models.BaseVAE"


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
    "+data.device_cache=true", "+training.fused_steps=on", "data.batch_size=auto",
    "+model.remat=block", "debug.nan_checks=true", "mesh.data=2",
    "debug.profile=true", "+parallel.explicit_shard_map=true",
])
def test_trainer_names_what_is_not_ported(tmp_path, config_dir, override):
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(_cfg(config_dir, tmp_path, 1, [override]))


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
        ttrainer._reject_unported(cfg)
        assert cfg["training"]["loss"]["type"] == "lpips_discriminator"
    full = compose(config_dir, "config", ["experiment=multi_modal_cvae"])
    model = build_model(full["model"], "bf16", "meta", train=True)
    assert sum(p.numel() for p in model.parameters()) == 906_331_075
    with pytest.raises(ValueError, match="empty logit map"):
        Trainer(compose(config_dir, "config", ["experiment=multi_modal_cvae_gan_quick", "device=cpu",
                                               f"work_dir={tmp_path}", "data.size=16", *TINY]))
