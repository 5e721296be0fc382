"""The port's data-parallel and GAN steps over gloo ranks against the JAX
package's shard_map steps on the 8 virtual CPU devices, and the dry runs.

Fixtures are those of tests/test_train.py: a tiny DisentangledConditionalVAE
(5 modalities, latent 4 + 4, hidden 8, ch_mult (1, 2); 16² inputs, which
the eval step's 11×11 SSIM window needs), SGD with
lr 1e-2 and momentum 0 (Adam's first step turns reduction-order noise into
±lr, tests/test_train.py:88-90), the reparameterization noise in the batch;
for the GAN step, the tiny 16² ConditionalVAE and ndf-8 PatchGAN of
tests/test_torch_port_gan.py with the gate open. JAX initialises every
model; the weights go through compat/jax_params.py into the port, the LPIPS
tower through an npz the port grafts. Bars are the port's fp32 ones: 2e-4
on outputs and losses, 5e-4 on parameters.

Ranks are spawned gloo processes (parallel/launch.py: one torch thread, a
`file://` store under tmp_path, joined within a timeout); JAX is imported
inside the fixtures so that a rank that imports this module stays light.
"""

import numpy as np
import pytest
import torch

from medvae_tpu_torch.parallel.launch import spawn

TOL, PARAM_TOL = 2e-4, 5e-4
RANK_TIMEOUT = 240
GLOBAL_BATCH = 8
FLAG = dict(num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, hidden_channels=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(), resolution=16)
LOSS = {"type": "disentangled_vae"}
SGD = ({"type": "sgd", "lr": 1e-2, "momentum": 0.0}, None)
CVAE = dict(input_channels=3, latent_dim=4, hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(16,), resolution=16)
DISC = dict(input_nc=3, ndf=8, n_layers=2)
GAN_LOSS = {"type": "lpips_discriminator", "discriminator_factor": 0.5, "perceptual_factor": 1.0,
            "pixel_factor": 1.0, "kl_factor": 1e-3, "discriminator_iter_start": 0}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(n=GLOBAL_BATCH, size=16, c=3, z=(8, 8), seed=0):
    rs = np.random.RandomState(seed)
    midx = (np.arange(n) % 5).astype(np.int32)
    return {
        "image_u8": rs.randint(0, 255, (n, size, size, c), np.uint8),
        "label": np.zeros((n,), np.int32),
        "modality_onehot": np.eye(12, dtype=np.float32)[midx],
        "modality_idx": midx,
        "channels": np.asarray([1, 3, 3, 1, 3], np.int32)[midx],
        "valid": np.ones((n,), np.float32),
        "noise": rs.randn(n, z[0], z[0], z[1]).astype(np.float32),
    }


def _flag_model(state_dict):
    from medvae_tpu_torch.config.models import build_model

    model = build_model(dict(FLAG, _target_="medvae_tpu.models.DisentangledConditionalVAE"), "fp32", "cpu",
                        train=True)
    model.load_state_dict(state_dict)
    return model


def _dp_rank(rank: int, world: int, state_dict, batch) -> dict:
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.parallel.shard_map_step import build_shard_map_train_step
    from medvae_tpu_torch.train.optim import build_optimizer
    from medvae_tpu_torch.train.state import create_train_state
    from medvae_tpu_torch.train.step import build_eval_step

    mesh = core_mesh.create_mesh(core_mesh.MeshSpec(data=world), core_mesh.current())
    model = _flag_model(state_dict)
    tx = build_optimizer(*SGD)
    state = create_train_state(model, tx)
    rows = mesh.local_rows(GLOBAL_BATCH)
    step = build_shard_map_train_step(model, LOSS, tx, mesh, max_channels=3)
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    state, metrics = step(state, local)
    evaluated = build_eval_step(model, LOSS, max_channels=3, group=mesh.group("batch"))(state, local)
    return {"params": {k: v.detach().clone() for k, v in state.params.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "eval": {k: float(evaluated[f"val/{k}"]) for k in ("separation_loss", "contrastive_loss")}}


def _gan_rank(rank: int, state_dict, disc_state, npz: str, batch) -> dict:
    from medvae_tpu_torch.config.models import build_model
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.nn.discriminator import build_discriminator
    from medvae_tpu_torch.parallel.shard_map_step import build_shard_map_gan_step
    from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
    from medvae_tpu_torch.train.state import create_train_state
    from medvae_tpu_torch.train.step import make_frozen

    mesh = core_mesh.create_mesh(core_mesh.MeshSpec(data=2), core_mesh.current())
    model = build_model(dict(CVAE, _target_="medvae_tpu.models.ConditionalVAE"), "fp32", "cpu", train=True)
    model.load_state_dict(state_dict)
    disc = build_discriminator(DISC, "cpu", seed=0)
    disc.load_state_dict(disc_state)
    tx, dtx = build_optimizer(*SGD), discriminator_optimizer(*SGD)
    state = create_train_state(model, tx, make_frozen(dict(GAN_LOSS, weights_path=npz), "cpu", seed=0),
                               disc=disc, disc_tx=dtx)
    rows = mesh.local_rows(GLOBAL_BATCH)
    step = build_shard_map_gan_step(model, GAN_LOSS, tx, mesh, disc, dtx, max_channels=3)
    state, metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
    return {"disc": {**{k: v.detach().clone() for k, v in state.disc_params.items()},
                     **{k: v.clone() for k, v in state.disc_batch_stats.items()}},
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """JAX's shard_map step on 2- and 4-device meshes, the port's on 2 and 4
    gloo ranks and in one process at the global batch, from the same
    weights, batch and noise: one step each."""
    import jax
    import jax.numpy as jnp

    from medvae_tpu.core.mesh import MeshSpec, create_mesh, replicate, shard_batch
    from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
    from medvae_tpu.parallel import build_shard_map_train_step
    from medvae_tpu.train import optim as joptim
    from medvae_tpu.train.state import create_train_state as jax_state
    from medvae_tpu_torch.compat.jax_params import from_jax_params
    from medvae_tpu_torch.train import optim as toptim
    from medvae_tpu_torch.train import state as tstate
    from medvae_tpu_torch.train import step as tstep

    jm = JaxDCVAE(**FLAG)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32))["params"])
    batch = _batch()
    jtx = joptim.build_optimizer(*SGD)
    init = from_jax_params(params, _flag_model_shape())
    out = {"init": init}
    for world in (2, 4):
        mesh = create_mesh(MeshSpec(data=world, model=1), jax.devices()[:world])
        step = build_shard_map_train_step(jm, LOSS, jtx, mesh, augment=False, max_channels=3, donate=False)
        state, metrics = step(replicate(mesh, jax_state(params, jtx)), shard_batch(mesh, batch),
                              jax.random.PRNGKey(3))
        model = _flag_model(init)
        out[f"jax{world}"] = {"params": from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), model),
                              "metrics": {k: float(v) for k, v in metrics.items()}}
        out[f"port{world}"] = spawn(_dp_rank, world, store_dir=str(tmp_path_factory.mktemp("dp")),
                                    args=(world, init, batch), timeout=RANK_TIMEOUT)
    model = _flag_model(init)
    ttx = toptim.build_optimizer(*SGD)
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, metrics = tstep.build_train_step(model, LOSS, ttx, max_channels=3)(tstate.create_train_state(model, ttx),
                                                                              whole)
    evaluated = tstep.build_eval_step(model, LOSS, max_channels=3)(state, whole)
    out["single"] = {"params": {k: v.detach().clone() for k, v in state.params.items()},
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "eval": {k: float(evaluated[f"val/{k}"]) for k in ("separation_loss", "contrastive_loss")}}
    return out


def _flag_model_shape():
    from medvae_tpu_torch.config.models import build_model

    return build_model(dict(FLAG, _target_="medvae_tpu.models.DisentangledConditionalVAE"), "fp32", "cpu",
                       train=True)


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in b)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax_shard_map(dp_runs, world):
    """Loss, every metric (the batch-global separation and contrastive
    losses on the gathered latent among them) and the params after one
    step, against JAX's shard_map step on `world` devices; the ranks agree
    with one another bit for bit."""
    want = dp_runs[f"jax{world}"]
    ranks = dp_runs[f"port{world}"]
    assert set(ranks[0]["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert abs(ranks[0]["metrics"][k] - v) <= TOL * max(1.0, abs(v)), k
    assert _max_abs(ranks[0]["params"], want["params"]) <= PARAM_TOL
    assert _max_abs(ranks[0]["params"], dp_runs["init"]) > 1e-4  # the step moved them
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], ranks[0]["params"][k]) for k in ranks[0]["params"])
        assert r["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_is_the_single_process_step_on_the_global_batch(dp_runs, world):
    """The port's own single-process step on the global batch: only an
    exact gather, whose backward sums every rank's cotangent, gives it (a
    detached gather loses the cross-rank term, a slice without the sum 1/N
    of it)."""
    got, want = dp_runs[f"port{world}"][0], dp_runs["single"]
    assert _max_abs(got["params"], want["params"]) <= 1e-6
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * max(1.0, abs(v)), k


@pytest.mark.parametrize("world", [2, 4])
def test_eval_step_takes_the_batch_global_losses_on_the_gathered_latent(dp_runs, world):
    got, want = dp_runs[f"port{world}"], dp_runs["single"]["eval"]
    for r in got:
        for k, v in want.items():
            assert abs(r["eval"][k] - v) <= 1e-5 * max(1.0, abs(v)), k


@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory):
    """JAX's shard_map GAN step on 2 devices and the port's on 2 ranks, one
    step past the gate."""
    import jax
    import jax.numpy as jnp

    from medvae_tpu.core.mesh import MeshSpec, create_mesh, replicate, shard_batch
    from medvae_tpu.losses.perceptual import LPIPSLoss as JaxLPIPSLoss
    from medvae_tpu.models import ConditionalVAE as JaxCVAE
    from medvae_tpu.nn.discriminator import NLayerDiscriminator as JaxDisc
    from medvae_tpu.parallel import build_shard_map_gan_step
    from medvae_tpu.train import optim as joptim
    from medvae_tpu.train.state import create_train_state as jax_state
    from medvae_tpu_torch.compat.jax_params import from_jax_disc_variables, from_jax_params
    from medvae_tpu_torch.config.models import build_model
    from medvae_tpu_torch.nn.discriminator import build_discriminator

    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jm, jdisc = JaxCVAE(**CVAE), JaxDisc(**DISC)
    params = np_tree(jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                             jnp.zeros((2, 16, 16, 3)), jnp.zeros((2, 12)))["params"])
    disc_vars = np_tree(jdisc.init(jax.random.PRNGKey(7), jnp.zeros((2, 16, 16, 3)), train=False))
    frozen = {"lpips": JaxLPIPSLoss().init(jax.random.PRNGKey(11), 16)}
    npz = tmp_path_factory.mktemp("towers") / "lpips.npz"
    leaves = jax.tree_util.tree_flatten_with_path(frozen["lpips"])[0]
    np.savez(npz, **{"/".join(k.key for k in kp): np.asarray(v) for kp, v in leaves})
    batch = _batch(size=16, z=(8, 4), seed=1)
    mesh = create_mesh(MeshSpec(data=2, model=1), jax.devices()[:2])
    jtx, jdtx = joptim.build_optimizer(*SGD), joptim.discriminator_optimizer(*SGD)
    step = build_shard_map_gan_step(jm, GAN_LOSS, jtx, mesh, jdisc, jdtx, augment=False, max_channels=3,
                                    donate=False)
    state = replicate(mesh, jax_state(params, jtx, frozen=frozen, disc_variables=disc_vars, disc_tx=jdtx))
    state, metrics = step(state, shard_batch(mesh, batch), jax.random.PRNGKey(2))
    model = build_model(dict(CVAE, _target_="medvae_tpu.models.ConditionalVAE"), "fp32", "cpu", train=True)
    disc = build_discriminator(DISC, "cpu", seed=0)
    want = {"params": from_jax_params(np_tree(state.params), model),
            "disc": from_jax_disc_variables({"params": np_tree(state.disc_params),
                                             "batch_stats": np_tree(state.disc_batch_stats)}, disc),
            "metrics": {k: float(v) for k, v in metrics.items()}}
    ranks = spawn(_gan_rank, 2, store_dir=str(tmp_path_factory.mktemp("gan")), timeout=RANK_TIMEOUT,
                  args=(from_jax_params(params, model), from_jax_disc_variables(disc_vars, disc), str(npz), batch))
    return want, ranks


@pytest.mark.parametrize("part", ["losses", "d_weight", "generator", "discriminator", "batch_stats"])
def test_gan_step_matches_jax_shard_map(gan_runs, part):
    """The GAN step on 2 ranks against JAX's on 2 devices: the generator's
    and the discriminator's losses and every log, the global adaptive
    weight, the generator's and D's params and D's sync-BN statistics."""
    want, ranks = gan_runs
    got = ranks[0]
    if part in ("losses", "d_weight"):
        keys = ["train/d_weight"] if part == "d_weight" else sorted(want["metrics"])
        assert set(got["metrics"]) == set(want["metrics"])
        for k in keys:
            v = want["metrics"][k]
            assert abs(got["metrics"][k] - v) <= TOL * max(1.0, abs(v)), k
        assert want["metrics"]["train/d_weight"] > 0
    elif part == "generator":
        assert _max_abs(got["params"], want["params"]) <= PARAM_TOL
    else:
        stats = [k for k in want["disc"] if "running" in k]
        keys = stats if part == "batch_stats" else [k for k in want["disc"] if k not in stats]
        assert _max_abs({k: got["disc"][k] for k in keys}, {k: want["disc"][k] for k in keys}) <= TOL
        # sync-BN: both ranks hold the same statistics and params
        assert all(torch.equal(ranks[1]["disc"][k], got["disc"][k]) for k in keys)


def test_dryrun_multichip_prints_its_five_lines(capfd):
    from medvae_tpu_torch.entry import dryrun_multichip

    lines = dryrun_multichip(4, device="cpu", timeout=RANK_TIMEOUT)
    printed = capfd.readouterr().out
    assert len(lines) == 5 and all(line in printed for line in lines)
    for line, what in zip(lines, ("shard_map DP", "jit DP2xTP2", "shard_map GAN", "fused 3-step chunk",
                                  "full-flagship loss surface")):
        assert line.startswith("dryrun_multichip(4) " + what) and ": ok, " in line
        values = [float(part.split("=")[1]) for part in line.split(": ok, ")[1].split(", ")]
        assert values and all(np.isfinite(values))


def test_dcn_dryrun_equals_the_one_node_run():
    """Two nodes of two ranks on a (dcn=2, data=2) mesh, each rank feeding
    its own rows, against the same job on a (data=4) mesh: the same losses
    on every rank."""
    from medvae_tpu_torch.parallel import dcn_dryrun

    two_nodes, one_node = dcn_dryrun.run(dcn=True, device="cpu"), dcn_dryrun.run(dcn=False, device="cpu")
    assert all(losses == two_nodes[0] for losses in two_nodes)
    np.testing.assert_allclose(two_nodes[0], one_node[0], rtol=TOL, atol=0)
    assert len(two_nodes[0]) == dcn_dryrun.N_ROWS // dcn_dryrun.BATCH and all(np.isfinite(two_nodes[0]))


@pytest.mark.parametrize("call", ["dryrun_multichip", "dcn_dryrun"])
def test_dry_runs_default_to_the_card(call):
    """Both dry runs ask for the card unless the caller asks for the CPU,
    and raise without one rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    from medvae_tpu_torch.entry import dryrun_multichip
    from medvae_tpu_torch.parallel import dcn_dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2) if call == "dryrun_multichip" else dcn_dryrun.main([])
