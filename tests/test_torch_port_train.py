"""The port's train step against the JAX package's `build_train_step`.

A small DisentangledConditionalVAE (the SMALL model of
tests/test_torch_port_model.py: hidden 32, ch_mult (1, 2), attention at 16²,
16² inputs, 5 modalities, fp32) is initialised by the JAX package, with the
flagship's loss on top: the disentangled ELBO with separation and contrastive
terms, LPIPS (AlexNet, 16² upsampled to 64²) and BiomedCLIP on a 2-layer,
width-64 CLIP ViT (16² cubic-resized to 224²). All params go through
`from_jax_params` into the port. Three steps of adamw (lr 1e-4, clip 1.0) on
the same uint8 batches and pinned reparameterization noise, augment off, with
an EMA of decay 0.9, JAX on a 1-device CPU mesh, must agree: every loss term
each step to 2e-4, the step-1 gradients to 5e-4 and the params after three
steps to 6e-4 (ROADMAP A.1).

6e-4 only bounds the params: Adam's normalized update moves every param by
about lr a step whatever the size of its gradient, so a gradient near zero
whose sign the two packages round differently can put two params 2·lr apart a
step. So the result of the updates is held by relative L2 per leaf: Adam's
moments mu and nu (smooth in the gradient) to 1e-4, the params' displacement
over the three steps to 2e-3, and the EMA's displacement to 1e-2 (it is the
difference of two numbers near 1, so fp32 rounding of the EMA sets its floor:
3.7e-3 measured). These leave out by rule the leaves whose step-1 gradient is
zero in exact arithmetic and rounding noise in practice (max |g| under 1e-6 of
the largest): key biases, which softmax ignores, and biases that a one-channel
GroupNorm group removes. A step that never updates the params, or steps them
the wrong way, misses the displacement bar by a factor of 500 or more.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu.core.mesh import replicate, shard_batch
from medvae_tpu.losses import clip_vit as jclip
from medvae_tpu.losses.perceptual import BiomedCLIPLoss as JaxBiomedCLIPLoss
from medvae_tpu.losses.perceptual import LPIPSLoss as JaxLPIPSLoss
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.train import optim as joptim
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu_torch.compat.jax_params import from_jax_grads, from_jax_params
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.losses.clip_vit import CLIPViT
from medvae_tpu_torch.losses.perceptual import LPIPSNet
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep

SMALL = dict(
    num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, hidden_channels=32,
    ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=16,
)
SMALL_VIT = dict(width=64, layers=2, heads=4, embed_dim=32)
LOSS = {
    "type": "disentangled_vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0,
    "separation_weight": 0.1, "contrastive_weight": 0.2,
    "perceptual_weight": 0.1, "biomedclip_weight": 0.1, "clip_encoder": "vit",
}
OPT = ({"type": "adamw", "lr": 1e-4}, {"type": "constant"})
STEPS, B = 3, 6
EMA = 0.9
CHANNELS = np.array([1, 3, 3, 1, 3], np.int32)


def _batches():
    rs = np.random.RandomState(0)
    midx = (np.arange(B) % 5).astype(np.int32)  # modality 0 twice: InfoNCE has a positive
    return [{
        "image_u8": rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
        "modality_idx": midx,
        "channels": CHANNELS[midx],
        "noise": rs.randn(B, 8, 8, 8).astype(np.float32),
    } for _ in range(STEPS)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs():
    """Both packages' three steps, from the same initial params."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = JaxDCVAE(**SMALL)
    variables = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32),
    )
    params = variables["params"]
    small_vit = functools.partial(jclip.CLIPViT, **SMALL_VIT)
    with pytest.MonkeyPatch.context() as mp:  # BiomedCLIPLoss builds its ViT on construction
        mp.setattr(jclip, "CLIPViT", small_vit)
        frozen = {
            "lpips": JaxLPIPSLoss().init(jax.random.PRNGKey(11), 16),
            "clip": JaxBiomedCLIPLoss(encoder="vit").init(jax.random.PRNGKey(13)),
        }
        jtx = joptim.build_optimizer(*OPT, gradient_clip_val=1.0)
        jtrain = jstep.build_train_step(jm, LOSS, jtx, mesh, augment=False, max_channels=3,
                                        donate=False, ema_decay=EMA)
        jcrit = jstep.make_criterion(LOSS, jm)
    forward = jstep.make_forward_fn(jm)
    batches = _batches()

    def jloss(p, batch):
        x = jstep.preprocess(batch, None, augment=False, max_channels=3)
        outputs = forward(p, x, batch, {"sample": jax.random.PRNGKey(0)}, deterministic=False)
        return jcrit(frozen, outputs, x)["loss"]

    jax_grads = jax.jit(jax.grad(jloss))(params, {k: jnp.asarray(v) for k, v in batches[0].items()})
    state = replicate(mesh, jstate.create_train_state(params, jtx, frozen=frozen, ema_decay=EMA))
    jax_metrics = []
    for batch in batches:
        state, metrics = jtrain(state, shard_batch(mesh, batch), jax.random.PRNGKey(2))
        jax_metrics.append({k: float(v) for k, v in metrics.items()})

    model = build_model(dict(SMALL, _target_="DisentangledConditionalVAE"), "fp32", "cpu", train=True)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    lpips, clip = LPIPSNet(), CLIPViT(**SMALL_VIT)
    for net, key in ((lpips, "lpips"), (clip, "clip")):
        net.load_state_dict(from_jax_params(frozen[key]["params"], net))
        net.eval().requires_grad_(False)
    ttx = toptim.build_optimizer(*OPT, gradient_clip_val=1.0)
    tst = tstate.create_train_state(model, ttx, frozen={"lpips": lpips, "clip": clip}, ema_decay=EMA)
    _, torch_grads = tstep.build_loss_and_grads(model, LOSS)(tst, _torch_batch(batches[0]))
    train = tstep.build_train_step(model, LOSS, ttx, augment=False, max_channels=3, ema_decay=EMA)
    torch_metrics = []
    for batch in batches:
        tst, metrics = train(tst, _torch_batch(batch))
        torch_metrics.append({k: float(v) for k, v in metrics.items()})
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    (adam,) = adam
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {
        "jax_metrics": jax_metrics, "torch_metrics": torch_metrics,
        "jax_grads": from_jax_grads(as_np(jax_grads), model),
        "torch_grads": dict(zip(tst.params, torch_grads)),
        "initial_params": from_jax_params(as_np(params), model),
        "jax_params": from_jax_params(as_np(state.params), model),
        "torch_params": {k: v.detach().clone() for k, v in tst.params.items()},
        "jax_mu": from_jax_grads(as_np(adam.mu), model),
        "jax_nu": from_jax_grads(as_np(adam.nu), model),
        "torch_mu": dict(zip(tst.params, tst.opt_state.mu)),
        "torch_nu": dict(zip(tst.params, tst.opt_state.nu)),
        "jax_ema": from_jax_params(as_np(state.ema_params), model),
        "torch_ema": tst.ema_params,
        "torch_state": tst,
    }


@pytest.mark.parametrize("step", range(STEPS))
def test_every_loss_term_matches_jax_each_step(runs, step):
    want, got = runs["jax_metrics"][step], runs["torch_metrics"][step]
    assert set(got) == set(want)
    assert {"train/p_loss", "train/bc_loss", "train/contrastive_loss"} <= set(got)
    for key in sorted(want):
        if key == "train/grad_norm":
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-4, err_msg=key)
    np.testing.assert_allclose(got["train/grad_norm"], want["train/grad_norm"], rtol=1e-3)


def test_step_one_gradients_match_jax(runs):
    want, got = runs["jax_grads"], runs["torch_grads"]
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)


def test_params_after_three_steps_match_jax(runs):
    want, got = runs["jax_params"], runs["torch_params"]
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=6e-4, rtol=0,
                                   err_msg=name)
    state = runs["torch_state"]
    assert state.step == STEPS and state.opt_state.count == STEPS
    assert max(m.abs().max().item() for m in state.opt_state.mu) > 0


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _live(runs):
    """The leaves whose step-1 gradient is not rounding noise around an exact
    zero (see the module docstring)."""
    grads = {n: np.abs(g.numpy()).max() for n, g in runs["jax_grads"].items()}
    floor = 1e-6 * max(grads.values())
    live = sorted(n for n, g in grads.items() if g > floor)
    assert len(live) >= 0.9 * len(grads)
    assert all(g < 1e-7 for n, g in grads.items() if n not in live)
    return live


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_adam_moments_after_three_steps_match_jax(runs, moment):
    want, got = runs[f"jax_{moment}"], runs[f"torch_{moment}"]
    assert set(got) == set(want)
    for name in _live(runs):
        assert _rel_l2(got[name].numpy(), want[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("kind", ["params", "ema"])
def test_displacement_after_three_steps_matches_jax(runs, kind):
    """How far the params (and their EMA) moved from the initial params."""
    start = runs["initial_params"]
    want, got = runs[f"jax_{kind}"], runs[f"torch_{kind}"]
    bar = {"params": 2e-3, "ema": 1e-2}[kind]
    for name in _live(runs):
        p0 = start[name].numpy().astype(np.float64)
        rel = _rel_l2(got[name].numpy() - p0, want[name].numpy() - p0)
        assert rel <= bar, (name, rel)


def _small(precision, train):
    return build_model(dict(SMALL, _target_="DisentangledConditionalVAE"), precision, "cpu", train=train)


def test_bf16_training_keeps_fp32_params_and_adam_state():
    model = init_weights(_small("bf16", train=True), seed=0)
    assert model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    tx = toptim.build_optimizer(*OPT, gradient_clip_val=1.0)
    state = tstate.create_train_state(model, tx)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    loss = dict(LOSS, perceptual_weight=0.0, biomedclip_weight=0.0)
    step = tstep.build_train_step(model, loss, tx, augment=True, max_channels=3)
    state, metrics = step(state, _torch_batch(_batches()[0]), torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(t.dtype == torch.float32 for t in state.opt_state.mu + state.opt_state.nu)
    assert any(not torch.equal(before[k], v) for k, v in state.params.items())
    # the convs computed in bf16 from the fp32 weights
    out = model.decode(torch.zeros((1, 8, 8, 8)), torch.zeros((1,), dtype=torch.long))
    assert out.dtype == torch.bfloat16


def test_serving_build_still_stores_bf16_conv_weights():
    model = _small("bf16", train=False)
    assert not model.training and model.dtype == torch.bfloat16
    assert model.encoder.conv_in.weight.dtype == torch.bfloat16
    assert model.encoder.conv_in.compute_dtype is None
    assert not any(p.requires_grad for p in model.parameters())
    assert model.encoder.norm_out.weight.dtype == torch.float32


@pytest.mark.parametrize("build", ["bf16 model", "lpips", "clip"])
def test_every_build_turns_tf32_off(build, monkeypatch):
    """fp32 math is exact fp32 on the card whatever the process built before:
    a bf16 model's build sets the cuDNN flag as an fp32 one does, and so do
    the fp32 loss towers of a bf16 train step."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if build == "bf16 model":
        _small("bf16", train=True)
    elif build == "lpips":
        tstep.make_frozen(dict(LOSS, biomedclip_weight=0.0), "meta")
    else:
        tstep.make_frozen(dict(LOSS, perceptual_weight=0.0, clip_encoder="simple"), "meta")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.deterministic  # repeatable fp32 conv backward


def test_unported_step_options_raise():
    """The GAN and tower-only loss types build, with bf16 towers too, and an
    unknown tower dtype or optimizer raises; gradient accumulation takes
    only a batch its k divides."""
    from medvae_tpu_torch.nn.discriminator import build_discriminator

    model = _small("fp32", train=True)
    tx = toptim.build_optimizer(*OPT)
    step = tstep.build_train_step(model, dict(LOSS, perceptual_weight=0.0, biomedclip_weight=0.0), tx,
                                  accumulate_grad_batches=4)
    with pytest.raises(ValueError, match=f"batch size {B} not divisible by accumulate_grad_batches=4"):
        step(tstate.create_train_state(model, tx), _torch_batch(_batches()[0]))
    disc = build_discriminator({"input_nc": 3, "ndf": 8, "n_layers": 2}, "cpu", seed=0)
    gan = {"disc": disc, "disc_tx": toptim.discriminator_optimizer(*OPT)}
    for loss_type in ("lpips_discriminator", "lpips", "biomedclip"):
        extra = gan if loss_type == "lpips_discriminator" else {}
        assert callable(tstep.build_train_step(model, {"type": loss_type}, tx, **extra))
        assert callable(tstep.build_eval_step(model, {"type": loss_type}, disc=extra.get("disc")))
        assert callable(tstep.build_train_step(model, {"type": loss_type}, tx, accumulate_grad_batches=2,
                                               **extra))
        # bf16 towers are built (their parity: tests/test_torch_port_runs.py)
        assert callable(tstep.build_train_step(model, {"type": loss_type, "tower_dtype": "bfloat16"}, tx,
                                               **extra))
        with pytest.raises(ValueError, match="tower_dtype"):
            tstep.build_train_step(model, {"type": loss_type, "tower_dtype": "float16"}, tx, **extra)
    assert callable(tstep.build_train_step(model, dict(LOSS, tower_dtype="bfloat16"), tx))
    assert toptim.build_optimizer({"type": "sgd"}).kind == "sgd"
    with pytest.raises(ValueError, match="Unknown optimizer type"):
        toptim.build_optimizer({"type": "lamb"})
    with pytest.raises(ValueError, match="train=True"):
        tstate.create_train_state(_small("fp32", train=False), tx)


def test_reparameterization_draws_from_the_generator():
    model = init_weights(_small("fp32", train=True), seed=1)
    x = torch.zeros((2, 16, 16, 3))
    m = torch.tensor([0, 1])
    run = lambda seed: model(x, m, generator=torch.Generator().manual_seed(seed))["z"]  # noqa: E731
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    noise = torch.randn((2, 8, 8, 8))
    out = model(x, m, noise=noise)
    mu, logvar = out["mu"], out["logvar"]
    torch.testing.assert_close(out["z"], mu + noise * torch.exp(0.5 * logvar))
    assert mu.abs().max() <= 10 and logvar.abs().max() <= 10


def _conv_weights_moved_by_one_step(model):
    """Share of conv weights an adamw step at lr 1e-4 changes."""
    from medvae_tpu_torch.nn.blocks import Conv2d

    tx = toptim.build_optimizer(*OPT, gradient_clip_val=1.0)
    state = tstate.create_train_state(model, tx)
    names = [n + ".weight" for n, m in model.named_modules() if isinstance(m, Conv2d)]
    before = {n: state.params[n].detach().float().clone() for n in names}
    loss = dict(LOSS, perceptual_weight=0.0, biomedclip_weight=0.0)
    tstep.build_train_step(model, loss, tx)(state, _torch_batch(_batches()[0]))
    moved = sum(int((state.params[n].float() != before[n]).sum()) for n in names)
    return moved / sum(before[n].numel() for n in names)


def test_fp32_params_keep_the_updates_that_bf16_stored_convs_lose():
    """The precision fault the training build repairs: training the serving
    build (convs stored in bf16) rounds about half of an lr-1e-4 Adam update
    away, since it is below half a bf16 ulp of the weight."""
    weights = init_weights(_small("fp32", train=False), seed=0).state_dict()
    stored_bf16 = _small("bf16", train=False)
    stored_bf16.load_state_dict(weights)
    stored_bf16.train().requires_grad_(True)
    repaired = _small("bf16", train=True)
    repaired.load_state_dict(weights)
    assert _conv_weights_moved_by_one_step(repaired) == 1.0
    assert _conv_weights_moved_by_one_step(stored_bf16) < 0.7
