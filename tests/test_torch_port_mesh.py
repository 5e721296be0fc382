"""The port's mesh against the JAX package's on the CPU: `MeshSpec.resolve`
over a grid (errors included), the ranks' feeder rows against JAX's global
batch bit for bit, the engine's mesh, and the Trainer over two gloo ranks.

JAX runs on submeshes of the 8 virtual CPU devices tests/conftest.py forces;
the port's ranks are spawned gloo processes (medvae_tpu_torch/parallel/
launch.py: one torch thread each, a `file://` store under tmp_path, joined
within a timeout). A rank's own rows need no process: `Mesh.local_rows`
depends only on the rank, so the feeder tests build each rank's Mesh in
this process. JAX is imported inside the tests, so that a spawned rank that
imports this module stays light.
"""

import json
import os

import numpy as np
import pytest
import torch

from medvae_tpu_torch.core import mesh as core_mesh
from medvae_tpu_torch.data import medmnist as tmed
from medvae_tpu_torch.data import pipeline as tpipe
from medvae_tpu_torch.parallel.launch import spawn

RANK_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


GRID = [  # (data, model, dcn, devices, processes)
    (-1, 1, 0, 8, 1), (-1, 2, 0, 8, 1), (4, 2, 0, 8, 1), (2, 4, 0, 8, 1), (8, 1, 0, 8, 1), (-1, 1, 0, 1, 1),
    (-1, 1, 0, 8, 2), (2, 2, 0, 8, 2), (-1, 2, 2, 8, 1), (4, 1, 2, 8, 2), (3, 1, 0, 8, 1), (2, 2, 0, 4, 2),
    (2, 1, 0, 1, 1), (-1, 3, 0, 8, 1), (-1, 1, 3, 8, 1),
]


@pytest.mark.parametrize("data, model, dcn, devices, processes", GRID)
def test_mesh_spec_resolves_as_jax(data, model, dcn, devices, processes):
    from medvae_tpu.core.mesh import MeshSpec as JaxMeshSpec

    def outcome(spec):
        try:
            return spec.resolve(devices, processes)
        except ValueError as e:
            return str(e)

    want = outcome(JaxMeshSpec(data=data, model=model, dcn=dcn))
    assert outcome(core_mesh.MeshSpec(data=data, model=model, dcn=dcn)) == want


@pytest.mark.parametrize("dcn, data, model", [(1, 2, 1), (1, 2, 2), (1, 1, 4), (2, 2, 1), (2, 2, 2)])
def test_rank_layout_is_jax_device_order(dcn, data, model):
    """Rank r holds JAX's device r of the (dcn, data, model) array: its
    coordinates, batch rank and rows of a global batch."""
    world = dcn * data * model
    order = np.arange(world).reshape(dcn, data, model)
    rows = []
    for r in range(world):
        m = core_mesh.Mesh(dcn=dcn, data=data, model=model, dist=core_mesh.Dist(rank=r, world=world))
        d, i, j = m.coords
        assert order[d, i, j] == r
        assert m.batch_rank == d * data + i and m.model_rank == j
        assert core_mesh.batch_axes(m) == (("dcn", "data") if dcn > 1 else "data")
        rows.append(m.local_rows(8 * dcn * data))
    for r, sl in enumerate(rows):  # model ranks of one batch rank share rows
        assert sl == rows[(r // model) * model]
    if dcn * data > 1:
        with pytest.raises(ValueError, match="not divisible"):
            core_mesh.Mesh(dcn=dcn, data=data, model=model, dist=core_mesh.Dist(world=world)).local_rows(
                dcn * data * 8 + 1)


def _split(n=336, size=8):
    rs = np.random.RandomState(3)
    midx = np.sort(rs.choice([0, 1, 3, 6, 9], size=n, p=[0.4, 0.2, 0.2, 0.1, 0.1])).astype(np.int32)
    return dict(images=rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
                labels=rs.randint(0, 9, n).astype(np.int32), modality_idx=midx, channels=3)


@pytest.mark.parametrize("cached", [False, True], ids=["host", "cached"])
@pytest.mark.parametrize("stratify", [False, True], ids=["plain", "stratified"])
@pytest.mark.parametrize("extent", [2, 4])
def test_ranks_rows_concatenate_to_the_jax_global_batch(cached, stratify, extent):
    """Every rank's rows of every batch of two epochs, concatenated in rank
    order, are the JAX feeder's global batch on an `extent`-device mesh, bit
    for bit; the validation feeder's ragged tail included."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from medvae_tpu.data import medmnist as jmed
    from medvae_tpu.data import pipeline as jpipe

    jmesh = JaxMesh(np.asarray(jax.devices()[:extent]).reshape(extent, 1), ("data", "model"))
    kinds = (jpipe.DeviceCachedFeeder, tpipe.DeviceCachedFeeder) if cached else (jpipe.DeviceFeeder,
                                                                                 tpipe.DeviceFeeder)
    for shuffle, drop_last in ((True, True), (False, False)):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=9, stratify=stratify and shuffle)
        ref = kinds[0](jmed.SplitArrays(**_split()), 32, jmesh, **kw)
        ranks = [kinds[1](tmed.SplitArrays(**_split()), 32, "cpu",
                          mesh=core_mesh.Mesh(dcn=1, data=extent, model=1,
                                              dist=core_mesh.Dist(rank=r, world=extent)), **kw)
                 for r in range(extent)]
        for epoch in range(2):
            want = list(ref.epoch(epoch))
            got = [list(f.epoch(epoch)) for f in ranks]
            assert all(len(g) == len(want) for g in got)
            for step, b_want in enumerate(want):
                for k in b_want:
                    cat = np.concatenate([g[step][k].numpy() for g in got])
                    assert cat.dtype == np.asarray(b_want[k]).dtype, k
                    assert np.array_equal(cat, np.asarray(b_want[k])), (epoch, step, k)


def test_cached_feeder_refuses_several_nodes():
    m = core_mesh.Mesh(dcn=2, data=2, model=1, dist=core_mesh.Dist(rank=0, world=4, local_world=2))
    with pytest.raises(ValueError, match="one node"):
        tpipe.DeviceCachedFeeder(tmed.SplitArrays(**_split()), 32, "cpu", mesh=m)


def test_engine_over_two_devices_equals_no_mesh_with_jax_bucket_rounding():
    """InferenceEngine(devices=["cpu", "cpu"]) answers every method as the
    engine without a mesh does, and rounds its buckets as JAX's engine over a
    2- and a 3-device mesh does."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from medvae_tpu.models import BaseVAE as JaxBaseVAE
    from medvae_tpu.serve.engine import InferenceEngine as JaxEngine
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.serve.engine import InferenceEngine

    jm = JaxBaseVAE(input_channels=1, latent_dim=4, hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1,
                    attn_resolutions=(), resolution=8)
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 8, 8, 1)))["params"]
    cfg = dict(_target_="medvae_tpu.models.DisentangledConditionalVAE", num_modalities=5,
               shared_latent_dim=4, modality_latent_dim=4, hidden_channels=8, ch_mult=[1, 2],
               num_res_blocks=1, attn_resolutions=[], resolution=16)
    model = init_weights(build_model(cfg, "fp32", "cpu"), seed=0)
    for n in (2, 3):
        jmesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
        want = JaxEngine(jm, params, buckets=(1, 3, 8, 32), mesh=jmesh).buckets
        got = InferenceEngine(model, buckets=(1, 3, 8, 32), devices=["cpu"] * n).buckets
        assert got == want
    plain = InferenceEngine(model, buckets=(1, 3, 8), device="cpu")
    meshed = InferenceEngine(model, buckets=(1, 3, 8), devices=["cpu", "cpu"])
    rs = np.random.RandomState(0)
    x = rs.randint(0, 255, (11, 16, 16, 3), np.uint8)
    midx = np.arange(11) % 5
    assert np.array_equal(plain.reconstruct(x, midx), meshed.reconstruct(x, midx))
    mean, logvar = plain.encode(x, midx)
    got_mean, got_logvar = meshed.encode(x, midx)
    assert np.array_equal(mean, got_mean) and np.array_equal(logvar, got_logvar)
    assert np.array_equal(plain.decode(mean, midx), meshed.decode(mean, midx))
    assert np.array_equal(plain.sample(5, midx[:5], seed=4), meshed.sample(5, midx[:5], seed=4))


# ------------------------------------------------------------ the Trainer -- #

TRAINER = ["experiment=multi_modal_cvae_quick", "device=cpu", "mesh.data=2", "model.hidden_channels=8",
           "data.dataset_names=[chestmnist,pathmnist]",
           "data.batch_size=16", "+training.limit_train_batches=2", "early_stopping.enabled=false",
           "training.log_images_every_n_epochs=0", "training.log_every_n_steps=1"]


def _trainer_rank(rank: int, config_dir: str, overrides: list) -> dict:
    from unittest import mock

    from medvae_tpu_torch.config.compose import compose
    from medvae_tpu_torch.train import checkpoint
    from medvae_tpu_torch.train.trainer import Trainer
    from medvae_tpu_torch.utils.logging import NullLogger

    saves = []
    real_save = torch.save

    def counted(obj, path, *a, **k):
        saves.append(str(path))
        return real_save(obj, path, *a, **k)

    with mock.patch.object(checkpoint.torch, "save", counted):
        trainer = Trainer(compose(config_dir, "config", overrides))
        trainer.fit()
    return {"saves": len(saves), "null_logger": isinstance(trainer.logger, NullLogger),
            "step": trainer.state.step, "mesh": trainer.mesh.shape}


def _final(work, name="multi_modal_cvae_quick_final"):
    path = os.path.join(work, "logs", "checkpoints", "multi_modal_cvae_quick", name, "checkpoint.pt")
    return torch.load(path, weights_only=True)


def test_two_rank_trainer_resumes_bit_for_bit_and_only_rank_0_writes(tmp_path, config_dir):
    """1 epoch, then resume=true to 2, against 2 epochs uninterrupted: the
    params, moments and step bit for bit; rank 1 holds a NullLogger and
    writes no checkpoint; each metric row is logged once."""
    store = str(tmp_path / "stores")
    a, c = str(tmp_path / "a"), str(tmp_path / "c")
    first = spawn(_trainer_rank, 2, store_dir=store, timeout=RANK_TIMEOUT,
                  args=(config_dir, [*TRAINER, "training.max_epochs=1", f"work_dir={a}"]))
    resumed = spawn(_trainer_rank, 2, store_dir=store, timeout=RANK_TIMEOUT,
                    args=(config_dir, [*TRAINER, "training.max_epochs=2", "resume=true", f"work_dir={a}"]))
    whole = spawn(_trainer_rank, 2, store_dir=store, timeout=RANK_TIMEOUT,
                  args=(config_dir, [*TRAINER, "training.max_epochs=2", f"work_dir={c}"]))
    for run in (first, resumed, whole):
        assert run[0]["mesh"] == {"data": 2, "model": 1}
        assert not run[0]["null_logger"] and run[1]["null_logger"]
        assert run[0]["saves"] > 0 and run[1]["saves"] == 0
    assert resumed[0]["step"] == whole[0]["step"] == 4
    got, want = _final(a), _final(c)
    for k in want["state_dict"]:
        assert torch.equal(got["state_dict"][k], want["state_dict"][k]), k
    for part in ("mu", "nu"):
        assert all(torch.equal(g, w) for g, w in zip(got["train_state"][part], want["train_state"][part]))
    with open(os.path.join(c, "logs", "multi_modal_cvae_quick", "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f if "train/loss" in line]
    assert len(steps) == len(set(steps)) == 4  # each step's row once (rank 0's)


def test_explicit_step_refuses_accumulation_as_jax(tmp_path, config_dir):
    from medvae_tpu_torch.config.compose import compose
    from medvae_tpu_torch.train.trainer import Trainer

    cfg = compose(config_dir, "config", ["experiment=multi_modal_cvae_quick", "device=cpu",
                                         "+parallel.explicit_shard_map=true",
                                         "training.accumulate_grad_batches=2", f"work_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="accumulate_grad_batches"):
        Trainer(cfg)
