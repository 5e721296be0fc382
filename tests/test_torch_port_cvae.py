"""The port's Base, Beta and Conditional VAEs, their train step, serving and
the bench and entry builders, against the JAX package on the CPU.

Small models (hidden 32, ch_mult (1, 2), one res block, attention at 16²,
16² inputs, 3 channels, latent 4, fp32) are initialised by the JAX package;
their params go through `from_jax_params` into the port. Inputs, one-hot
conditions and reparameterization noise are made with numpy from seeds and
handed to both. Tolerances: forward outputs 2e-4 (the port's fp32 bar);
three train steps of the ConditionalVAE (adam 1e-3, clip 1.0) every loss term
2e-4 and the step-1 gradients 5e-4, once with MEDVAE_FUSED_GN off and once on
(the JAX model then takes its Pallas GN+SiLU kernels in interpret mode, the
port the plain versions of B6/B7); bf16 `entry()` against
`__graft_entry__.entry` 5e-2 relative L2 (the repo's bf16-vs-fp32 bar).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh

from medvae_tpu.core.mesh import replicate, shard_batch
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import BetaVAE as JaxBetaVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.ops import groupnorm_swish as jgn
from medvae_tpu.serve.engine import InferenceEngine as JaxEngine
from medvae_tpu.train import optim as joptim
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu.train.trainer import build_model as jax_build_model
from medvae_tpu_torch import bench
from medvae_tpu_torch.compat.jax_params import from_jax_grads, from_jax_params, plan_jax_params
from medvae_tpu_torch.config.models import CVAE_BENCH, build_model
from medvae_tpu_torch.nn.blocks import ResnetBlock
from medvae_tpu_torch.serve.engine import InferenceEngine, cond_width
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep

SMALL = dict(input_channels=3, latent_dim=4, hidden_channels=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,), resolution=16)
TOL = 2e-4
CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "model"
B = 6
FAMILIES = {"BaseVAE": JaxBaseVAE, "BetaVAE": JaxBetaVAE, "ConditionalVAE": JaxCVAE}


def _onehot(midx, width=12):
    return np.eye(width, dtype=np.float32)[midx]


def _init_jax(cls, use_pallas=False, **extra):
    jm = cls(**SMALL, use_pallas=use_pallas, **extra)
    args = [jnp.zeros((2, 16, 16, 3))]
    if cls is JaxCVAE:
        args.append(jnp.zeros((2, 12)))
    variables = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, *args)
    return jm, jax.tree_util.tree_map(np.asarray, variables["params"])


def _port(name, params, precision="fp32", train=False):
    tm = build_model(dict(SMALL, _target_=f"medvae_tpu.models.{name}"), precision, "cpu", train=train)
    tm.load_state_dict(from_jax_params(params, tm))
    return tm


@pytest.fixture(scope="module")
def cvae():
    jm, params = _init_jax(JaxCVAE)
    return jm, params, _port("ConditionalVAE", params)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    midx = np.array([0, 3, 11, 2, 7, 5])
    noise = rs.randn(B, 8, 8, 4).astype(np.float32)
    return x, midx, noise


# ------------------------------------------------------------- models ---- #


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_matches_jax(name):
    jm, params = _init_jax(FAMILIES[name])
    tm = _port(name, params)
    x, midx, noise = _data()
    cond = [] if name != "ConditionalVAE" else [_onehot(midx)]
    want = jax.jit(lambda p, *a, noise: jm.apply({"params": p}, *a, noise=noise))(
        params, jnp.asarray(x), *map(jnp.asarray, cond), noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *map(torch.from_numpy, cond), noise=torch.from_numpy(noise))
    for key in ("reconstruction", "mean", "logvar", "z"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, err_msg=key)
    assert ("condition" in got) == (name == "ConditionalVAE")


@pytest.mark.parametrize("size", [16, 28])
def test_condition_map_matches_jax(cvae, size):
    """Linear -> ReLU -> (C, 8, 8) in Unflatten order -> bilinear 8 -> size."""
    jm, params, tm = cvae
    cond = _onehot(np.array([0, 4, 9]))
    want = jm.apply({"params": params}, jnp.asarray(cond), size, size,
                    method=jm.create_condition_map)
    with torch.no_grad():
        got = tm.create_condition_map(torch.from_numpy(cond), size, size)
    assert got.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conditional_sample_decodes_unconditionally_like_jax(cvae):
    jm, params, tm = cvae
    _, midx, noise = _data(1)
    want = jm.apply({"params": params}, jnp.asarray(noise), method=jm.decode)
    with torch.no_grad():
        got = tm.conditional_sample(B, torch.from_numpy(_onehot(midx)), noise=torch.from_numpy(noise))
        other = tm.conditional_sample(B, torch.zeros(B, 12), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    torch.testing.assert_close(got, other)


def test_modality_condition_and_the_ignored_num_modalities(cvae):
    jm, _, tm = cvae
    np.testing.assert_array_equal(tm.get_modality_condition("oct"), jm.get_modality_condition("oct"))
    with pytest.raises(ValueError):
        tm.get_modality_condition("mri")
    quick = build_model(dict(SMALL, _target_="ConditionalVAE", num_modalities=4), "fp32", "meta")
    assert quick.cond_dim == 12 and quick.encoder.conv_in.weight.shape[1] == 6


def test_beta_is_read_by_the_loss_under_use_model_beta():
    model = build_model(dict(SMALL, _target_="BetaVAE", beta=2.5), "fp32", "meta")
    loss = {"type": "vae", "kl_weight": 1.0, "recon_weight": 1.0}
    rs = np.random.RandomState(2)
    outputs = {k: torch.from_numpy(rs.randn(2, 8, 8, 4).astype(np.float32)) for k in ("mean", "logvar")}
    outputs["reconstruction"] = torch.zeros(2, 16, 16, 3)
    plain = tstep.make_criterion(loss, model)({}, outputs, torch.zeros(2, 16, 16, 3))
    beta = tstep.make_criterion(dict(loss, use_model_beta=True), model)({}, outputs, torch.zeros(2, 16, 16, 3))
    torch.testing.assert_close(beta["loss"] - beta["recon_loss"], 2.5 * plain["kl_loss"])


@pytest.mark.parametrize("name", ["base_vae", "beta_vae", "conditional_vae"])
def test_converter_covers_the_full_size_trees(name):
    """Every leaf of the 224² config's JAX param tree maps onto the port
    model once with the right shape (the concat conv_in takes 2·C); shapes
    only, no memory used."""
    cfg = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())
    jm = jax_build_model(cfg, precision="bf16", use_pallas=False)
    args = [jnp.zeros((1, 224, 224, 1))] + ([jnp.zeros((1, 12))] if name == "conditional_vae" else [])
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(1)}, *args)["params"]
    tm = build_model(cfg, "bf16", "meta")
    expected = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    plan = plan_jax_params(shapes, expected)
    assert len(plan) == len(expected) == len(jax.tree_util.tree_leaves(shapes))
    if name == "conditional_vae":
        assert expected["encoder.conv_in.weight"] == (128, 2, 3, 3)
        assert expected["condition_proj.weight"] == (64, 12)


@pytest.mark.parametrize("name", ["base_vae_quick", "beta_vae_quick", "conditional_vae_quick"])
def test_quick_configs_build_with_their_dropout(name):
    """The quick configs set dropout 0.1, which the port now takes (it raised
    until dropout was ported): every key of theirs builds, and every res
    block drops at their rate."""
    cfg = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())["model"]
    model = build_model(cfg, "bf16", "meta", train=True)
    assert model.resolution == 28
    assert {m.dropout for m in model.modules() if isinstance(m, ResnetBlock)} == {0.1}


def test_cvae_bench_config_is_bench_py_default(monkeypatch):
    import bench as jax_bench

    monkeypatch.delenv("BENCH_CONFIG", raising=False)
    arch, size, batch = jax_bench._config()
    assert (size, batch) == (28, 4096)
    for key, value in arch.items():
        assert CVAE_BENCH[key] == (list(value) if isinstance(value, tuple) else value), key
    assert CVAE_BENCH["input_channels"] == 3 and CVAE_BENCH["condition_method"] == "concat"
    assert bench.bench_config("cvae")[4] == 4096 and bench.bench_config("flagship", "full224")[4] == 32


# --------------------------------------------------------- train step ---- #

LOSS = {"type": "vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0}
OPT = ({"type": "adam", "lr": 1e-3}, {"type": "constant"})
STEPS = 3
CHANNELS = np.array([1, 3, 3, 1, 3])


def _batches():
    rs = np.random.RandomState(3)
    midx = np.arange(B) % 5
    return [{
        "image_u8": rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
        "modality_onehot": _onehot(midx),
        "modality_idx": midx.astype(np.int32),
        "channels": CHANNELS[midx].astype(np.int32),
        "noise": rs.randn(B, 8, 8, 4).astype(np.float32),
    } for _ in range(STEPS)]


@pytest.fixture(scope="module", params=["off", "on"])
def runs(request):
    """Both packages' three CVAE steps from the same params, with
    MEDVAE_FUSED_GN off or on."""
    fused = request.param == "on"
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDVAE_FUSED_GN", "1" if fused else "0")
        mp.setattr(jgn, "_on_tpu", lambda: True)
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
            jm, params = _init_jax(JaxCVAE, use_pallas=fused)
            jtx = joptim.build_optimizer(*OPT, gradient_clip_val=1.0)
            jtrain = jstep.build_train_step(jm, LOSS, jtx, mesh, augment=False, max_channels=3,
                                            donate=False)
            jcrit = jstep.make_criterion(LOSS, jm)
            forward = jstep.make_forward_fn(jm)

            def jloss(p, batch):
                x = jstep.preprocess(batch, None, augment=False, max_channels=3)
                outputs = forward(p, x, batch, {"sample": jax.random.PRNGKey(0)})
                return jcrit({}, outputs, x)["loss"]

            jax_grads = jax.jit(jax.grad(jloss))(params, {k: jnp.asarray(v) for k, v in batches[0].items()})
            state = replicate(mesh, jstate.create_train_state(params, jtx))
            jax_metrics = []
            for batch in batches:
                state, metrics = jtrain(state, shard_batch(mesh, batch), jax.random.PRNGKey(2))
                jax_metrics.append({k: float(v) for k, v in metrics.items()})

        model = _port("ConditionalVAE", params, train=True)
        ttx = toptim.build_optimizer(*OPT, gradient_clip_val=1.0)
        tst = tstate.create_train_state(model, ttx)
        as_torch = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]
        _, torch_grads = tstep.build_loss_and_grads(model, LOSS)(tst, as_torch[0])
        train = tstep.build_train_step(model, LOSS, ttx, augment=False, max_channels=3)
        torch_metrics = []
        for batch in as_torch:
            tst, metrics = train(tst, batch)
            torch_metrics.append({k: float(v) for k, v in metrics.items()})
    return {
        "jax_metrics": jax_metrics, "torch_metrics": torch_metrics,
        "jax_grads": from_jax_grads(jax.tree_util.tree_map(np.asarray, jax_grads), model),
        "torch_grads": dict(zip(tst.params, torch_grads)),
    }


@pytest.mark.parametrize("step", range(STEPS))
def test_every_loss_term_matches_jax_each_step(runs, step):
    want, got = runs["jax_metrics"][step], runs["torch_metrics"][step]
    for key in ("train/loss", "train/recon_loss", "train/kl_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-4, err_msg=key)
    np.testing.assert_allclose(got["train/grad_norm"], want["train/grad_norm"], rtol=1e-3)


def test_step_one_gradients_match_jax(runs):
    want, got = runs["jax_grads"], runs["torch_grads"]
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------------ serving ---- #


def test_engine_serves_the_conditional_vae_like_the_jax_engine(cvae):
    """Mixed modality names and indices, one-hot width cond_dim (12), index
    bound 12, a request longer than the largest bucket."""
    jm, params, tm = cvae
    port = InferenceEngine(tm, buckets=(1, 4), device="cpu")
    ref = JaxEngine(jm, params, buckets=(1, 4))
    images = np.random.RandomState(4).randint(0, 256, (6, 16, 16, 3), np.uint8)
    mods = [0, 11, 3, 5, 8, 2]
    np.testing.assert_allclose(port.reconstruct(images, modality=mods),
                               ref.reconstruct(images, modality=mods), atol=TOL)
    for want, got in zip(ref.encode(images[:2], modality="octmnist"),
                         port.encode(images[:2], modality="octmnist")):
        np.testing.assert_allclose(got, want, atol=TOL)
    assert port.sample(3, modality="pathmnist", seed=1).shape == (3, 16, 16, 3)
    assert port.info() == {**ref.info(), "buckets": [1, 4]}
    with pytest.raises(ValueError, match="out of range"):
        port.reconstruct(images[:1], modality=[12])


def test_engine_serves_a_base_vae_unconditionally():
    jm, params = _init_jax(JaxBaseVAE)
    tm = _port("BaseVAE", params)
    port = InferenceEngine(tm, buckets=(2,), device="cpu")
    ref = JaxEngine(jm, params, buckets=(2,))
    images = np.random.RandomState(5).randint(0, 256, (3, 16, 16, 3), np.uint8)
    np.testing.assert_allclose(port.reconstruct(images, modality=[0, 4, 9]),
                               ref.reconstruct(images, modality=[0, 4, 9]), atol=TOL)
    z = np.random.RandomState(6).randn(2, 8, 8, 4).astype(np.float32)
    np.testing.assert_allclose(port.decode(z), ref.decode(z), atol=TOL)
    assert port.info()["conditional"] is False and port.info() == {**ref.info(), "buckets": [2]}
    assert port._modality_indices([1, 11], 2).tolist() == [1, 11] and cond_width(tm) == 12
    with pytest.raises(ValueError, match="out of range"):
        port.encode(images[:1], modality=-1)


# --------------------------------------------------- entry and bench ---- #


def test_entry_matches_the_graft_entry():
    import __graft_entry__ as graft
    from medvae_tpu_torch.entry import ENTRY_MODEL, entry

    jfn, (jparams, jx, jmidx, key) = graft.entry()
    fn, (params, x, midx, noise) = entry(device="cpu")
    tm = build_model(ENTRY_MODEL, "bf16", "meta")
    converted = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tm)
    converted = {k: v.to(params[k].dtype) for k, v in converted.items()}
    assert x.shape == jx.shape and x.dtype == torch.bfloat16
    assert midx.tolist() == np.asarray(jmidx).tolist()
    # the example image is zeros, which zero-bias weights map to zeros: feed
    # both functions one random bf16 image instead
    image = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, x.shape).astype(np.float32))
    image = image.bfloat16()
    jimage = jnp.asarray(image.float().numpy(), jnp.bfloat16)
    recon, mean, logvar = fn(converted, image, midx, noise)
    _, jmean, jlogvar = jfn(jparams, jimage, jmidx, key)
    jrecon = graft._flagship_model().apply({"params": jparams}, jimage, jmidx,
                                           noise=jnp.asarray(noise.numpy()))["reconstruction"]

    def rel(a, b):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert recon.dtype == torch.bfloat16 and recon.shape == (8, 28, 28, 3)
    for got, want in ((recon, jrecon), (mean, jmean), (logvar, jlogvar)):
        assert rel(got, want) <= 5e-2


@pytest.mark.parametrize("model", ["cvae", "flagship"])
def test_bench_builder_steps_on_the_cpu(model):
    net, step, state, batch = bench.build_bench(model, "quick", batch_size=8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    flops, state = bench.flops_per_step(step, state, batch, gen)
    state, metrics = step(state, batch, gen)
    assert flops > 0 and state.step == 2
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert batch["image_u8"].shape == (8, 28, 28, 3) and net.dtype == torch.bfloat16
