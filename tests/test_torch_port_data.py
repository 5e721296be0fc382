"""The port's training stack below the Trainer, on the CPU: dropout, the
data, the feeder, the metrics, the eval step and config composition.

Against the JAX package, with inputs from numpy seeds: the synthetic MedMNIST
splits and the feeder's batches (shuffled, stratified, eval-padded, over two
epochs) bitwise; the metrics 1e-5; the eval step of each model family 2e-4
(absolute, and relative for PSNR and the KL totals, which are tens to
thousands); `compose` equal as plain dicts. The Trainer and `cli/train.py`
runs are in tests/test_torch_port_trainer.py.
"""

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
from medvae_tpu_torch.compat.jax_params import from_jax_params
from medvae_tpu_torch.config.compose import compose
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.data import medmnist as tmed
from medvae_tpu_torch.data import pipeline as tpipe
from medvae_tpu_torch.nn.blocks import ResnetBlock, dropout
from medvae_tpu_torch.train import metrics as tmetrics
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep
from medvae_tpu_torch.train.optim import build_optimizer


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
