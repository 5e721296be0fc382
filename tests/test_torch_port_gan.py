"""The port's GAN path against the JAX package on the CPU: the PatchGAN
discriminator, the GAN loss, the dual-optimizer step and its eval step, and
the tower-only `lpips` and `biomedclip` criteria.

Small models: a hidden-8 ConditionalVAE (concat, ch_mult (1, 2), one res
block, attention at 16², latent 4, 3 channels) and a 1-channel hidden-8
BaseVAE, both fp32 at 16², and a discriminator with ndf 8 and n_layers 2
(16² → a 2 × 2 logit map). The JAX package initialises every model; the VAE
and discriminator variables go through compat/jax_params.py into the port,
the LPIPS tower through an npz grafted by the port's `make_frozen`
(`loss.weights_path`). Images, one-hot conditions and reparameterization
noise come from numpy seeds; augment is off and dropout 0.

Bars are the port's fp32 ones: outputs, loss terms, params, D params and
BatchNorm statistics 2e-4; gradients 5e-4. Params after three steps are
held at 2e-4 absolute with adamw at lr 2e-5 (D 1e-5): Adam's normalized
update moves a param by about lr a step whatever its gradient's size, so a
gradient that is rounding noise around an exact zero (conv biases before a
one-channel GroupNorm group, attention key biases) can put the two packages'
params up to 2·lr apart a step. Whether the updates are the JAX ones is then
held by the displacement over three steps, relative L2 ≤ 2e-3 per leaf whose
step-one gradient is more than rounding noise. The JAX side is built once per
module (one jit of `make_gan_grads_fn`, one of the train step, one of the
eval step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu.core.mesh import replicate, shard_batch
from medvae_tpu.losses import gan as jgan
from medvae_tpu.losses.perceptual import BiomedCLIPLoss as JaxBiomedCLIPLoss
from medvae_tpu.losses.perceptual import LPIPSLoss as JaxLPIPSLoss
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.nn.discriminator import NLayerDiscriminator as JaxDisc
from medvae_tpu.train import optim as joptim
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu_torch.compat.jax_params import from_jax_disc_variables, from_jax_grads, from_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.losses import gan as tgan
from medvae_tpu_torch.nn.discriminator import NLayerDiscriminator, build_discriminator, logit_size
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep

TOL, GRAD_TOL = 2e-4, 5e-4
B, STEPS = 4, 3
CVAE = dict(input_channels=3, latent_dim=4, hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(16,), resolution=16)
BASE = dict(CVAE, input_channels=1, attn_resolutions=())
DISC = dict(input_nc=3, ndf=8, n_layers=2)
LOSS = {"type": "lpips_discriminator", "discriminator_factor": 0.5, "perceptual_factor": 1.0,
        "pixel_factor": 1.0, "kl_factor": 1e-3, "discriminator_iter_start": 1}
OPT = ({"type": "adamw", "lr": 2e-5, "weight_decay": 1e-5, "betas": [0.5, 0.999]},
       {"type": "constant"})


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(channels, n, seed=0, conditional=True):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        midx = rs.randint(0, 5, B).astype(np.int32)
        batch = {"image_u8": rs.randint(0, 256, (B, 16, 16, channels)).astype(np.uint8),
                 "modality_idx": midx, "noise": rs.randn(B, 8, 8, 4).astype(np.float32)}
        if conditional:
            batch["modality_onehot"] = np.eye(12, dtype=np.float32)[midx]
            batch["channels"] = np.array([1, 3, 3, 1, 3], np.int32)[midx]
        out.append(batch)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _write_npz(path, tree):
    """A tower's JAX variables as the flat `params/a/b` npz the grafts read."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(path, **{"/".join(k.key for k in kp): np.asarray(v) for kp, v in leaves})
    return str(path)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX models, discriminator and LPIPS tower, and the tower as an
    npz the port grafts."""
    jdisc = JaxDisc(**DISC)
    disc_vars = _np(jdisc.init(jax.random.PRNGKey(7), jnp.zeros((2, 16, 16, 3)), train=False))
    frozen = {"lpips": JaxLPIPSLoss().init(jax.random.PRNGKey(11), 16)}
    npz = _write_npz(tmp_path_factory.mktemp("towers") / "lpips.npz", frozen["lpips"])
    models = {}
    for name, cls, cfg, args in (("cvae", JaxCVAE, CVAE, (jnp.zeros((2, 16, 16, 3)), jnp.zeros((2, 12)))),
                                 ("base", JaxBaseVAE, BASE, (jnp.zeros((2, 16, 16, 1)),))):
        jm = cls(**cfg)
        variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                     *args)
        models[name] = (jm, _np(variables["params"]))
    return {"disc": jdisc, "disc_vars": disc_vars, "frozen": frozen, "npz": npz, "models": models}


def _port(jax_side, name, loss=LOSS):
    """Fresh port model, discriminator and towers with the JAX weights."""
    cfg = {"cvae": CVAE, "base": BASE}[name]
    target = {"cvae": "ConditionalVAE", "base": "BaseVAE"}[name]
    model = build_model(dict(cfg, _target_=f"medvae_tpu.models.{target}"), "fp32", "cpu", train=True)
    model.load_state_dict(from_jax_params(jax_side["models"][name][1], model))
    disc = build_discriminator(DISC, "cpu", seed=0)
    disc.load_state_dict(from_jax_disc_variables(jax_side["disc_vars"], disc))
    frozen = tstep.make_frozen(dict(loss, weights_path=jax_side["npz"]), "cpu", seed=0)
    return model, disc, frozen


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------- discriminator ---- #


@pytest.mark.parametrize("actnorm", [False, True])
def test_discriminator_forward_and_batch_stats_match_jax(actnorm):
    """Eval mode, then train mode on real then fake images: the logits of
    each call and, for BatchNorm, the running statistics after the two."""
    jdisc = JaxDisc(**DISC, use_actnorm=actnorm)
    variables = _np(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((2, 16, 16, 3)), train=False))
    disc = NLayerDiscriminator(**DISC, use_actnorm=actnorm)
    disc.load_state_dict(from_jax_disc_variables(variables, disc))
    rs = np.random.RandomState(4)
    real, fake = (rs.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32) for _ in range(2))
    want_eval = jdisc.apply(variables, jnp.asarray(real), train=False)
    want_real, mut = jdisc.apply(variables, jnp.asarray(real), train=True, mutable=["batch_stats"])
    after_real = {**variables, **_np(mut)}
    want_fake, mut = jdisc.apply(after_real, jnp.asarray(fake), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = disc(torch.from_numpy(real), train=False)
        got_real = disc(torch.from_numpy(real), train=True)
        got_fake = disc(torch.from_numpy(fake), train=True)
    assert got_eval.shape == (3, logit_size(16, 2), logit_size(16, 2), 1) == want_eval.shape
    for got, want in ((got_eval, want_eval), (got_real, want_real), (got_fake, want_fake)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    if actnorm:
        assert not list(disc.buffers()) and "batch_stats" not in variables
        assert disc.conv1.bias is None and disc.conv_out.bias is not None
        return
    stats = from_jax_disc_variables({"params": variables["params"], **_np(mut)}, disc)
    for name, buf in disc.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
        assert not torch.equal(buf, torch.zeros_like(buf) if "mean" in name else torch.ones_like(buf))


def test_discriminator_init_is_flax_families_from_the_seed():
    a = NLayerDiscriminator(**DISC).init_weights(5)
    b = NLayerDiscriminator(**DISC).init_weights(5)
    c = NLayerDiscriminator(**DISC).init_weights(6)
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    w = a.conv1.weight  # lecun_normal: truncated at 2 std, variance 1/fan_in
    fan_in = w[0].numel()
    assert w.abs().max() <= 2.0 / 0.8796256610342398 * fan_in**-0.5 + 1e-6
    assert abs(w.var().item() * fan_in - 1.0) < 0.1
    assert torch.equal(a.conv1.bias, torch.zeros_like(a.conv1.bias))
    assert torch.equal(a.norm1.weight, torch.ones(16)) and torch.equal(a.norm1.running_var, torch.ones(16))


def test_logit_size_and_the_empty_map():
    assert [logit_size(s, 3) for s in (224, 28, 16)] == [26, 1, 0]
    assert logit_size(16, 2) == 2


# ----------------------------------------------------------------- loss ---- #


def test_hinge_and_adaptive_weight_match_jax():
    rs = np.random.RandomState(5)
    real, fake = rs.randn(3, 4, 4, 1).astype(np.float32), rs.randn(3, 4, 4, 1).astype(np.float32)
    np.testing.assert_allclose(float(tgan.hinge_d_loss(torch.from_numpy(real), torch.from_numpy(fake))),
                               float(jgan.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)
    a, b = rs.randn(8, 3, 3, 3).astype(np.float32), rs.randn(8, 3, 3, 3).astype(np.float32)
    for scale in (1.0, 1e-9):  # the second clamps at 1e4
        got = tgan.adaptive_weight([torch.from_numpy(a)], [torch.from_numpy(b * scale)])
        want = jgan.adaptive_weight(jnp.asarray(a), jnp.asarray(b * scale))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert not got.requires_grad
    assert float(tgan.adaptive_weight([torch.from_numpy(a)], [torch.from_numpy(b * 1e-9)])) == 1e4


@pytest.mark.parametrize("step", [0, 1])
def test_generator_and_discriminator_loss_dicts_match_jax(jax_side, step):
    """Every log term of both heads on the same inputs, before (step 0) and
    after (step 1) the gate; with the pixel term and without."""
    rs = np.random.RandomState(6)
    x, rec = (rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32) for _ in range(2))
    kl = rs.uniform(0, 50, (B,)).astype(np.float32)
    lf, lr_ = rs.randn(B, 2, 2, 1).astype(np.float32), rs.randn(B, 2, 2, 1).astype(np.float32)
    _, _, frozen = _port(jax_side, "base")
    for pixel in (0.0, 1.0):
        cfg = dict(LOSS, pixel_factor=pixel)
        jl = jstep.make_gan_loss(cfg)
        tl = tstep.make_gan_loss(cfg)
        jloss, jlog = jl.generator_loss(jax_side["frozen"], jnp.asarray(x), jnp.asarray(rec),
                                        jnp.asarray(kl), jnp.asarray(lf), jnp.asarray(0.7), jnp.asarray(step))
        d_valid = torch.tensor(tl.d_valid(step))  # the step's host value as a 0-d tensor
        tloss, tlog = tl.generator_loss(frozen, torch.from_numpy(x), torch.from_numpy(rec),
                                        torch.from_numpy(kl), torch.from_numpy(lf), torch.tensor(0.7), d_valid)
        _, jd = jl.discriminator_loss(jnp.asarray(lr_), jnp.asarray(lf), jnp.asarray(step))
        _, td = tl.discriminator_loss(torch.from_numpy(lr_), torch.from_numpy(lf), d_valid)
        want, got = {**jlog, **jd}, {**tlog, **td}
        assert set(got) == set(want) and ("train/pix_loss" in got) == bool(pixel)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
        if step == 0:
            assert all(float(got[f"train/{k}"]) == 0.0
                       for k in ("d_weight", "g_loss", "d_loss", "logits_real", "logits_fake"))


# ----------------------------------------------------------------- step ---- #


@pytest.fixture(scope="module")
def cvae_runs(jax_side):
    """JAX and port: step-one gradients (make_gan_grads_fn at step 1, past
    the gate) and a 3-step trajectory of the train step."""
    jm, params = jax_side["models"]["cvae"]
    jdisc, disc_vars = jax_side["disc"], jax_side["disc_vars"]
    batches = _batches(3, STEPS)
    gan_loss = jstep.make_gan_loss(LOSS)
    jgrads_fn = jstep.make_gan_grads_fn(jm, jdisc, gan_loss)

    @jax.jit
    def jax_grads(batch):
        x = jstep.preprocess(batch, None, augment=False, max_channels=3)
        rngs = {"sample": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
        return jgrads_fn(params, disc_vars["params"], disc_vars["batch_stats"], jax_side["frozen"],
                         x, batch, rngs, jnp.asarray(1))

    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jg, jd, jstats, jlogs = _np(jax_grads(jb0))

    mesh = _mesh()
    jtx, jdtx = joptim.build_optimizer(*OPT), joptim.discriminator_optimizer(*OPT)
    jtrain = jstep.build_train_step(jm, LOSS, jtx, mesh, augment=False, max_channels=3,
                                    disc=jdisc, disc_tx=jdtx, donate=False)
    state = replicate(mesh, jstate.create_train_state(params, jtx, frozen=jax_side["frozen"],
                                                      disc_variables=disc_vars, disc_tx=jdtx))
    jax_metrics = []
    for batch in batches:
        state, metrics = jtrain(state, shard_batch(mesh, batch), jax.random.PRNGKey(2))
        jax_metrics.append({k: float(v) for k, v in metrics.items()})

    model, disc, frozen = _port(jax_side, "cvae")
    ttx, tdtx = toptim.build_optimizer(*OPT), toptim.discriminator_optimizer(*OPT)
    tst = tstate.create_train_state(model, ttx, frozen, disc=disc, disc_tx=tdtx)
    tst.step = 1
    tg, td, tlogs = tstep.build_gan_grads(model, disc, LOSS)(tst, _torch_batch(batches[0]))
    step_one_stats = {k: v.clone() for k, v in tst.disc_batch_stats.items()}

    model, disc, frozen = _port(jax_side, "cvae")
    tst = tstate.create_train_state(model, ttx, frozen, disc=disc, disc_tx=tdtx)
    train = tstep.build_train_step(model, LOSS, ttx, augment=False, max_channels=3, disc=disc, disc_tx=tdtx)
    torch_metrics = []
    for batch in batches:
        tst, metrics = train(tst, _torch_batch(batch))
        torch_metrics.append({k: float(v) for k, v in metrics.items()})
    return {
        "model": model, "disc": disc, "state": tst,
        "jax_grads": from_jax_grads(jg, model), "torch_grads": dict(zip(tst.params, tg)),
        "jax_d_grads": from_jax_disc_variables({"params": jd, "batch_stats": jstats}, disc),
        "torch_d_grads": dict(zip(tst.disc_params, td)),
        "jax_step_one_stats": from_jax_disc_variables({"params": jd, "batch_stats": jstats}, disc),
        "torch_step_one_stats": step_one_stats,
        "jax_logs": {k: float(v) for k, v in jlogs.items()},
        "torch_logs": {k: float(v) for k, v in tlogs.items()},
        "jax_metrics": jax_metrics, "torch_metrics": torch_metrics,
        "initial": from_jax_params(params, model),
        "jax_params": from_jax_params(_np(state.params), model),
        "jax_disc": from_jax_disc_variables(
            {"params": _np(state.disc_params), "batch_stats": _np(state.disc_batch_stats)}, disc),
    }


def test_step_one_gradients_match_jax(cvae_runs):
    """The generator's and the discriminator's gradients and logs of one GAN
    step past the gate, and the BatchNorm statistics after its two D calls."""
    r = cvae_runs
    assert set(r["torch_logs"]) == set(r["jax_logs"])
    for k, want in r["jax_logs"].items():
        np.testing.assert_allclose(r["torch_logs"][k], want, rtol=TOL, atol=1e-7, err_msg=k)
    assert r["torch_logs"]["train/d_weight"] > 0
    for got, want in ((r["torch_grads"], r["jax_grads"]), (r["torch_d_grads"], r["jax_d_grads"])):
        want = {k: v for k, v in want.items() if k in got}
        assert set(got) == set(want)
        for name in sorted(want):
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=GRAD_TOL, rtol=0,
                                       err_msg=name)
    assert max(g.abs().max().item() for g in r["torch_d_grads"].values()) > 1e-3
    for name, buf in r["torch_step_one_stats"].items():
        np.testing.assert_allclose(buf.numpy(), r["jax_step_one_stats"][name].numpy(), atol=TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("step", range(STEPS))
def test_every_log_term_matches_jax_each_step(cvae_runs, step):
    want, got = cvae_runs["jax_metrics"][step], cvae_runs["torch_metrics"][step]
    assert set(got) == set(want)
    assert {"train/pix_loss", "train/d_loss", "train/logits_fake"} <= set(got)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=1e-7, err_msg=key)
    adversarial = ("train/d_weight", "train/g_loss", "train/d_loss", "train/logits_real",
                   "train/logits_fake")
    if step == 0:  # before the gate both packages zero the adversarial terms
        assert all(got[k] == 0.0 and want[k] == 0.0 for k in adversarial)
    else:
        assert got["train/d_weight"] > 0 and got["train/d_loss"] > 0


def _live(grads):
    mags = {n: np.abs(g.numpy()).max() for n, g in grads.items()}
    floor = 1e-6 * max(mags.values())
    return sorted(n for n, m in mags.items() if m > floor)


def test_params_and_discriminator_after_three_steps_match_jax(cvae_runs):
    r = cvae_runs
    state = r["state"]
    assert state.step == STEPS and state.opt_state.count == STEPS and state.disc_opt_state.count == STEPS
    got = {k: v.detach() for k, v in state.params.items()}
    got_disc = {**{k: v.detach() for k, v in state.disc_params.items()}, **state.disc_batch_stats}
    for mine, theirs in ((got, r["jax_params"]), (got_disc, r["jax_disc"])):
        assert set(mine) == set(theirs)
        for name in sorted(theirs):
            np.testing.assert_allclose(mine[name].numpy(), theirs[name].numpy(), atol=TOL, rtol=0,
                                       err_msg=name)
    for name in _live(r["jax_grads"]):  # the generator moved as JAX's did
        p0 = r["initial"][name].numpy().astype(np.float64)
        rel = _rel_l2(got[name].numpy() - p0, r["jax_params"][name].numpy() - p0)
        assert rel <= 2e-3, (name, rel)


def test_generator_backward_leaves_no_gradient_on_the_discriminator(cvae_runs):
    assert all(p.grad is None for p in cvae_runs["disc"].parameters())
    assert all(p.grad is None for p in cvae_runs["model"].parameters())


def test_before_the_gate_d_still_moves_its_stats_and_decays(jax_side):
    """Step 0 (before the gate): D's gradients are zero, yet its BatchNorm
    statistics move and adamw decays its weights (by lr·wd, D's lr being
    half the generator's), as in the JAX package."""
    model, disc, frozen = _port(jax_side, "base")
    cfg = dict(LOSS, discriminator_iter_start=5)
    opt = (dict(OPT[0], weight_decay=0.1), OPT[1])
    ttx, tdtx = toptim.build_optimizer(*opt), toptim.discriminator_optimizer(*opt)
    state = tstate.create_train_state(model, ttx, frozen, disc=disc, disc_tx=tdtx)
    before = {k: v.detach().clone() for k, v in {**state.disc_params, **state.disc_batch_stats}.items()}
    step = tstep.build_train_step(model, cfg, ttx, max_channels=1, disc=disc, disc_tx=tdtx)
    state, metrics = step(state, _torch_batch(_batches(1, 1, seed=3, conditional=False)[0]))
    assert all(float(metrics[f"train/{k}"]) == 0.0 for k in ("d_weight", "d_loss", "g_loss"))
    after = {**state.disc_params, **state.disc_batch_stats}
    for name, old in before.items():
        new = after[name].detach()
        if name.startswith("norm") and "running" in name:
            assert not torch.equal(new, old), name
        elif name.endswith("weight"):  # conv kernels and BatchNorm scales
            torch.testing.assert_close(new, old * (1.0 - 1e-5 * 0.1), rtol=2e-7, atol=0)
            assert not torch.equal(new, old), name
        else:  # biases start at 0 and decay stays 0
            assert torch.equal(new, old), name


def test_gan_step_options_and_refusals(jax_side):
    model, disc, frozen = _port(jax_side, "base")
    ttx, tdtx = toptim.build_optimizer(*OPT), toptim.discriminator_optimizer(*OPT)
    step = tstep.build_train_step(model, LOSS, ttx, disc=disc, disc_tx=tdtx, accumulate_grad_batches=3)
    state = tstate.create_train_state(model, ttx, frozen, disc=disc, disc_tx=tdtx)
    with pytest.raises(ValueError, match=f"batch size {B} not divisible by accumulate_grad_batches=3"):
        step(state, _torch_batch(_batches(1, 1, conditional=False)[0]))
    with pytest.raises(ValueError, match="disc="):
        tstep.build_train_step(model, LOSS, ttx)
    bf16 = tstep.build_train_step(model, dict(LOSS, tower_dtype="bfloat16"), ttx, disc=disc, disc_tx=tdtx)
    assert bf16.gan_loss.perceptual_loss.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="tower_dtype"):
        tstep.build_train_step(model, dict(LOSS, tower_dtype="float16"), ttx, disc=disc, disc_tx=tdtx)
    with pytest.raises(ValueError, match="disc_tx"):
        tstate.create_train_state(model, ttx, frozen, disc=disc)
    assert (tdtx.b1, tdtx.b2) == (0.5, 0.999) and tdtx.schedule(0) == 0.5 * ttx.schedule(0)


def test_eval_step_gan_terms_match_jax(jax_side):
    """The 1-channel BaseVAE's eval step with the GAN loss: val/loss and
    every generator and discriminator term (d_weight 0, D in eval mode),
    and the reconstruction metrics."""
    jm, params = jax_side["models"]["base"]
    jdisc, disc_vars = jax_side["disc"], jax_side["disc_vars"]
    batch = _batches(1, 1, seed=8, conditional=False)[0]
    batch["valid"] = np.array([1, 1, 1, 0], np.float32)
    jtx, jdtx = joptim.build_optimizer(*OPT), joptim.discriminator_optimizer(*OPT)
    state = jstate.create_train_state(params, jtx, frozen=jax_side["frozen"], disc_variables=disc_vars,
                                      disc_tx=jdtx).replace(step=jnp.asarray(3, jnp.int32))
    jeval = jstep.build_eval_step(jm, LOSS, _mesh(), max_channels=1, disc=jdisc)
    want = {k: np.asarray(v) for k, v in jeval(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                                 jax.random.PRNGKey(0)).items()}
    model, disc, frozen = _port(jax_side, "base")
    ttx, tdtx = toptim.build_optimizer(*OPT), toptim.discriminator_optimizer(*OPT)
    tst = tstate.create_train_state(model, ttx, frozen, disc=disc, disc_tx=tdtx)
    tst.step = 3
    stats = {k: v.clone() for k, v in disc.named_buffers()}
    got = tstep.build_eval_step(model, LOSS, max_channels=1, disc=disc)(tst, _torch_batch(batch))
    assert set(got) == set(want)
    assert {"val/loss", "val/d_loss", "val/pix_loss", "val/logits_real"} <= set(got)
    for k in sorted(want):
        rel = k in ("val/psnr", "val/kl_total", "val/kl_loss", "val/_psnr_by_mod", "val/loss",
                    "val/total_loss")
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL if rel else 0,
                                   atol=0 if rel else TOL, err_msg=k)
    assert float(got["val/d_weight"]) == 0.0
    assert all(torch.equal(v, stats[k]) for k, v in disc.named_buffers())  # eval mode


# --------------------------------------------------- tower-only losses ---- #


@pytest.mark.parametrize("loss_type", ["lpips", "biomedclip"])
def test_tower_only_criteria_match_jax(jax_side, loss_type, tmp_path):
    """The `lpips` and `biomedclip` criteria on the same images and towers
    (the CLIP fallback CNN, grafted through its npz like LPIPS)."""
    rs = np.random.RandomState(9)
    x, rec = (rs.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32) for _ in range(2))
    cfg = {"type": loss_type, "clip_encoder": "simple"}
    if loss_type == "lpips":
        jfrozen = jax_side["frozen"]
        cfg["weights_path"] = jax_side["npz"]
    else:
        jfrozen = {"clip": JaxBiomedCLIPLoss(encoder="simple").init(jax.random.PRNGKey(13))}
        cfg["clip_weights_path"] = _write_npz(tmp_path / "clip.npz", jfrozen["clip"])
    jcrit = jstep.make_criterion(cfg, None)
    want = jcrit(jfrozen, {"reconstruction": jnp.asarray(rec)}, jnp.asarray(x))
    frozen = tstep.make_frozen(cfg, "cpu", seed=0)
    assert set(frozen) == ({"lpips"} if loss_type == "lpips" else {"clip"})
    got = tstep.make_criterion(cfg, None)(frozen, {"reconstruction": torch.from_numpy(rec)},
                                          torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL, err_msg=k)


def test_frozen_towers_of_each_loss_type():
    seeds = {}
    for loss_type, extra, keys in (("lpips_discriminator", {}, {"lpips"}),
                                   ("lpips_discriminator", {"use_biomedclip_loss": True}, {"lpips", "clip"}),
                                   ("lpips", {}, {"lpips"}), ("biomedclip", {}, {"clip"}),
                                   ("vae", {}, set())):
        frozen = tstep.make_frozen({"type": loss_type, **extra}, "meta", seed=0)
        assert set(frozen) == keys, loss_type
        assert all(not p.requires_grad for net in frozen.values() for p in net.parameters())
        seeds[(loss_type, tuple(extra))] = frozen
    plan = tstep._tower_plan({"type": "lpips_discriminator", "use_biomedclip_loss": True})
    assert {k: v[0] for k, v in plan.items()} == {"lpips": 11, "clip": 13}
    assert tstep._tower_plan({"type": "biomedclip"})["clip"][0] == 11
