"""The port's tensor parallelism against the JAX package's on the CPU.

  * The shard decisions: the port's rule on torch's layout against JAX's
    `state_shardings` over the full-width 224² flagship's param tree
    (shapes only), model = 2 and 4, `heads_conv2` included.
  * One step of the 8² BaseVAE of tests/test_tensor_parallel.py on a
    (data=2, model=2) mesh: four gloo ranks against JAX's jit DP×TP step on
    a (2, 2) submesh of the 8 virtual devices; SGD, lr 1e-2, momentum 0,
    the noise in the batch, weights through compat/jax_params.py; fp32 bars
    2e-4 on the loss and 5e-4 on the params. Each rank's checkpoint of the
    sharded state holds full tensors, and restores on the other layout.
  * A grouped conv whose shard splits a group (the case `heads_conv2` meets
    where m divides its outputs across a group) against the unsharded conv:
    output and gradients.
"""

import os

import numpy as np
import pytest
import torch

from medvae_tpu_torch.parallel.launch import spawn

TOL, PARAM_TOL = 2e-4, 5e-4
RANK_TIMEOUT = 240
BASE = dict(input_channels=1, latent_dim=8, hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(), dropout=0.0, resolution=8)
SGD = ({"type": "sgd", "lr": 1e-2, "momentum": 0.0}, None)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("m", [2, 4])
def test_shard_decisions_are_jax_state_shardings_over_the_flagship(m):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from medvae_tpu.train.trainer import build_model as jax_build_model
    from medvae_tpu.parallel import state_shardings
    from medvae_tpu_torch.compat.jax_params import plan_jax_params
    from medvae_tpu_torch.config.models import FLAGSHIP, build_model
    from medvae_tpu_torch.parallel.tensor_parallel import param_sharding_rule
    from medvae_tpu_torch.parallel.tensor_parallel import state_shardings as port_shardings

    jm = jax_build_model(FLAGSHIP, precision="bf16", use_pallas=False)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 224, 224, 3), jnp.float32), jnp.zeros((1,), jnp.int32))["params"]
    mesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(8 // m, m), ("data", "model"))
    jax_sharded = {
        tuple(getattr(k, "key", str(k)) for k in path): "model" in str(sh.spec)
        for path, sh in jax.tree_util.tree_flatten_with_path(state_shardings(shapes, mesh))[0]}
    model = build_model(FLAGSHIP, "bf16", "meta", train=True)
    params = dict(model.named_parameters())
    port = port_shardings(params, m)
    plan = plan_jax_params(shapes, {k: tuple(v.shape) for k, v in params.items()})
    assert len(plan) == len(port)
    for path, name, _ in plan:
        assert (port[name] == 0) == jax_sharded[path], (path, name)
    assert sum(v == 0 for v in port.values()) > 100
    # the grouped heads: 5 modalities x 3 channels do not divide by m, as in JAX
    assert tuple(params["heads_conv2.weight"].shape) == (15, 3, 3, 3) and port["heads_conv2.weight"] is None
    assert param_sharding_rule(("heads_conv2", "weight"), (20, 4, 3, 3), 2) == 0


def _batch(n=8):
    rs = np.random.RandomState(0)
    return {"image_u8": rs.randint(0, 255, (n, 8, 8, 1), np.uint8), "label": np.zeros(n, np.int32),
            "modality_onehot": np.zeros((n, 12), np.float32), "modality_idx": np.zeros(n, np.int32),
            "channels": np.ones(n, np.int32), "valid": np.ones(n, np.float32),
            "noise": rs.randn(n, 4, 4, 8).astype(np.float32)}


def _base_model(state_dict):
    from medvae_tpu_torch.config.models import build_model

    model = build_model(dict(BASE, _target_="medvae_tpu.models.BaseVAE"), "fp32", "cpu", train=True)
    model.load_state_dict(state_dict)
    return model


def _tp_rank(rank: int, state_dict, batch, ckpt_dir: str) -> dict:
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.parallel import tensor_parallel as tp
    from medvae_tpu_torch.parallel.shard_map_step import build_dp_train_step
    from medvae_tpu_torch.train.checkpoint import CheckpointManager
    from medvae_tpu_torch.train.optim import build_optimizer
    from medvae_tpu_torch.train.state import create_train_state

    mesh = core_mesh.create_mesh(core_mesh.MeshSpec(data=2, model=2), core_mesh.current())
    model = _base_model(state_dict)
    full_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    shards = tp.shard_model(model, mesh)
    layout = tp.ShardLayout([model])
    tx = build_optimizer(*SGD)
    state = create_train_state(model, tx)
    params = list(state.params.values())
    step = build_dp_train_step(model, {"type": "vae"}, tp.with_tp_norm(tx, params, layout), mesh, max_channels=1)
    rows = mesh.local_rows(8)
    state, metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
    full = {k: layout.full(p, p).clone() for k, p in state.params.items()}
    ckpt = CheckpointManager(ckpt_dir, {}, "fp32", layout=layout, writer=rank == 0,
                             barrier=lambda: core_mesh.barrier(mesh))
    ckpt.save_step(state)
    # restore into a fresh sharded state: every rank takes its own rows back
    fresh = _base_model(state_dict)
    tp.shard_model(fresh, mesh)
    reader = CheckpointManager(ckpt_dir, {}, "fp32", layout=tp.ShardLayout([fresh]), writer=False)
    back = reader.restore(create_train_state(fresh, tx), "last")
    restored = all(torch.equal(back.params[k], state.params[k]) for k in state.params)
    return {"full": full, "metrics": {k: float(v) for k, v in metrics.items()}, "sharded": sorted(shards),
            "bytes": sum(p.numel() * p.element_size() for p in params), "full_bytes": full_bytes,
            "restored": restored}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from medvae_tpu.core.mesh import MeshSpec, create_mesh, shard_batch
    from medvae_tpu.models import BaseVAE as JaxBaseVAE
    from medvae_tpu.parallel import shard_state, state_shardings
    from medvae_tpu.train import optim as joptim
    from medvae_tpu.train.state import create_train_state as jax_state
    from medvae_tpu.train.step import build_train_step
    from medvae_tpu_torch.compat.jax_params import from_jax_params

    jm = JaxBaseVAE(**BASE)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)}, jnp.zeros((2, 8, 8, 1)))["params"])
    jtx = joptim.build_optimizer(*SGD)
    state0 = jax_state(params, jtx)
    mesh = create_mesh(MeshSpec(data=2, model=2), jax.devices()[:4])
    step = build_train_step(jm, {"type": "vae"}, jtx, mesh, augment=False, max_channels=1, donate=False,
                            state_sharding=state_shardings(state0, mesh))
    batch = _batch()
    state, metrics = step(shard_state(state0, mesh), shard_batch(mesh, batch), jax.random.PRNGKey(7))
    init = from_jax_params(params, _base_model_shape())
    want = {"params": from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), _base_model(init)),
            "metrics": {k: float(v) for k, v in metrics.items()}}
    ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    ranks = spawn(_tp_rank, 4, store_dir=str(tmp_path_factory.mktemp("tp")), args=(init, batch, ckpt_dir),
                  timeout=RANK_TIMEOUT)
    return want, ranks, init, ckpt_dir


def _base_model_shape():
    from medvae_tpu_torch.config.models import build_model

    return build_model(dict(BASE, _target_="medvae_tpu.models.BaseVAE"), "fp32", "cpu", train=True)


def test_dp_tp_step_matches_jax_jit_dp_tp(tp_runs):
    want, ranks, init, _ = tp_runs
    got = ranks[0]
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= TOL * max(1.0, abs(v)), k
    assert max(float((got["full"][k] - want["params"][k]).abs().max()) for k in want["params"]) <= PARAM_TOL
    assert max(float((got["full"][k] - init[k]).abs().max()) for k in init) > 1e-4
    for r in ranks[1:]:  # every rank's gathered params alike
        assert all(torch.equal(r["full"][k], got["full"][k]) for k in got["full"])


def test_each_rank_holds_a_shard_and_checkpoints_hold_full_tensors(tp_runs):
    from medvae_tpu_torch.cli.common import load_checkpoint

    _, ranks, init, ckpt_dir = tp_runs
    got = ranks[0]
    assert "encoder.conv_in.weight" in got["sharded"] and all(r["sharded"] == got["sharded"] for r in ranks)
    assert got["bytes"] < 0.7 * got["full_bytes"]
    assert all(r["restored"] for r in ranks)
    saved = load_checkpoint(os.path.join(ckpt_dir, "last"))["state_dict"]
    assert set(saved) == set(init)
    assert all(torch.equal(saved[k], got["full"][k]) for k in saved)
    # a full checkpoint loads into an unsharded model, as any other
    _base_model(saved)


def _grouped_rank(rank: int) -> dict:
    from torch import nn

    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.nn.blocks import Conv2d
    from medvae_tpu_torch.parallel import tensor_parallel as tp

    mesh = core_mesh.create_mesh(core_mesh.MeshSpec(data=1, model=2), core_mesh.current())
    torch.manual_seed(0)
    full = nn.Sequential(Conv2d(6, 6, 3, padding=1, groups=3))  # shards of 3 rows, groups of 2
    x = torch.randn(2, 6, 5, 5)
    sharded = nn.Sequential(Conv2d(6, 6, 3, padding=1, groups=3))
    sharded.load_state_dict(full.state_dict())
    tp.shard_model(sharded, mesh)
    out = {}
    for name, module in (("full", full), ("sharded", sharded)):
        xi = x.clone().requires_grad_(True)
        y = module(xi)
        (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
        w = module[0].weight
        out[name] = {"y": y.detach(), "dx": xi.grad,
                     "dw": w.grad if name == "full" else w.grad.clone(), "db": module[0].bias.grad}
    out["rows"] = sharded[0].column.rows
    out["rank"] = mesh.model_rank
    return out


def test_grouped_conv_whose_shard_splits_a_group_matches_the_full_conv(tmp_path):
    ranks = spawn(_grouped_rank, 2, store_dir=str(tmp_path), timeout=RANK_TIMEOUT)
    for r in ranks:
        full, sharded = r["full"], r["sharded"]
        assert r["rows"] == 3
        for k in ("y", "dx", "db"):
            assert torch.allclose(sharded[k], full[k], atol=1e-5, rtol=1e-6), k
        lo = r["rank"] * 3
        assert torch.allclose(sharded["dw"], full["dw"][lo:lo + 3], atol=1e-5, rtol=1e-6)
