"""The port's training losses against the JAX package: the ELBO terms and
their NaN scrubbing, the flagship's separation and InfoNCE losses, the frozen
LPIPS and CLIP towers (values and d(loss)/d(recon)), the hand-built resizes,
and the converter's tower maps.

The towers are small where the JAX package allows it (a 2-layer, width-64
CLIP ViT); their params come from JAX's init through `from_jax_params`.
Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.losses import elbo as jelbo
from medvae_tpu.losses import perceptual as jperc
from medvae_tpu.losses.clip_vit import CLIPViT as JaxCLIPViT
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu_torch.compat.jax_params import from_jax_params, plan_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.losses import elbo as telbo
from medvae_tpu_torch.losses import perceptual as tperc
from medvae_tpu_torch.losses.clip_vit import CLIPViT

SMALL = dict(
    num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, hidden_channels=32,
    ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=16,
)
SMALL_VIT = dict(width=64, layers=2, heads=4, embed_dim=32)


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------------ ELBO ---- #


def _outputs(seed, bad=None):
    rs = np.random.RandomState(seed)
    out = {
        "reconstruction": rs.randn(3, 8, 8, 3).astype(np.float32),
        "mean": rs.randn(3, 4, 4, 8).astype(np.float32),
        "logvar": rs.randn(3, 4, 4, 8).astype(np.float32) * 0.5,
        "separation_loss": np.float32(-1.7),
        "contrastive_loss": np.float32(2.3),
    }
    out["mu"] = out["mean"]
    if bad == "nan":
        out["reconstruction"][0, 0, 0, 0] = np.nan
        out["separation_loss"] = np.float32(np.inf)
        out["contrastive_loss"] = np.float32(np.nan)
    return out, rs.randn(3, 8, 8, 3).astype(np.float32)


def _compare(jd, td):
    assert set(jd) == set(td)
    for key in jd:
        np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["mse", "l1", "bce"])
def test_vae_loss_matches_jax(kind):
    out, target = _outputs(0)
    want = jelbo.VAELoss(recon_loss_type=kind, kl_weight=0.5, beta=2.0)(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(target))
    got = telbo.VAELoss(recon_loss_type=kind, kl_weight=0.5, beta=2.0)(
        {k: _t(v) for k, v in out.items()}, _t(target))
    _compare(want, got)


@pytest.mark.parametrize("bad", [None, "nan"])
def test_disentangled_loss_terms_and_scrubbing_match_jax(bad):
    out, target = _outputs(1, bad)
    kw = dict(separation_weight=0.1, contrastive_weight=0.2)
    want = jelbo.DisentangledVAELoss(**kw)({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(target))
    got = telbo.DisentangledVAELoss(**kw)({k: _t(v) for k, v in out.items()}, _t(target))
    _compare(want, got)
    if bad:
        assert got["recon_loss"].item() == 0.0 and got["separation_loss"].item() == 0.0
        assert got["contrastive_loss"].item() == 0.0 and np.isfinite(got["loss"].item())


def test_non_finite_total_becomes_the_1e6_sentinel():
    out, target = _outputs(2)
    kw = dict(kl_weight=1e39)  # past the fp32 range: the weighted KL is inf
    want = jelbo.DisentangledVAELoss(**kw)({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(target))
    got = telbo.DisentangledVAELoss(**kw)({k: _t(v) for k, v in out.items()}, _t(target))
    assert float(want["loss"]) == 1e6 and got["loss"].item() == 1e6


def test_gaussian_kl_matches_jax():
    mean, logvar = _np(3, 2, 5), _np(4, 2, 5)
    np.testing.assert_allclose(
        telbo.gaussian_kl(_t(mean), _t(logvar)).numpy(),
        np.asarray(jelbo.gaussian_kl(jnp.asarray(mean), jnp.asarray(logvar))), rtol=1e-6,
    )


# ------------------------------------------------- separation, InfoNCE ---- #


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxDCVAE(**SMALL)
    x = jnp.zeros((2, 16, 16, 3))
    variables = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, jnp.zeros((2,), jnp.int32)
    )
    tm = build_model(dict(SMALL, _target_="DisentangledConditionalVAE"), "fp32", "cpu", train=True)
    return jm, variables["params"], tm


MODALITIES = {
    "all_present": [0, 1, 2, 3, 4, 0, 2, 4],
    "some_absent": [0, 2, 2, 0, 2, 0, 2, 2],
    "single": [3, 3, 3, 3, 3, 3, 3, 3],
    "no_positives": [0, 1, 2, 3, 4, 5, 6, 7],
}


def _z(seed, coincide=False):
    z = _np(seed, 8, 8, 8, 8)
    if coincide:
        # one latent of halves for every sample: every sum and centroid is
        # exact, so the centroids coincide exactly in both packages
        z[:] = np.round(z[0] * 2) / 2
    return z


@pytest.mark.parametrize("loss", ["modality_separation_loss", "contrastive_loss"])
@pytest.mark.parametrize("mods", sorted(MODALITIES))
def test_disentanglement_losses_and_grads_match_jax(jax_model, loss, mods):
    jm, params, tm = jax_model
    z = _z(5)
    midx = np.asarray(MODALITIES[mods], np.int32)

    def jfn(zz):
        return jm.apply({"params": params}, zz, jnp.asarray(midx), method=getattr(JaxDCVAE, loss))

    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = getattr(tm, loss)(zt, torch.from_numpy(midx))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_grad), atol=1e-5)
    if mods == "single" and loss == "modality_separation_loss":
        assert got.item() == 0.0


def test_separation_grad_is_finite_and_matches_jax_at_coincident_centroids(jax_model):
    jm, params, tm = jax_model
    z = _z(6, coincide=True)
    midx = np.asarray(MODALITIES["some_absent"], np.int32)
    jgrad = jax.grad(lambda zz: jm.apply({"params": params}, zz, jnp.asarray(midx),
                                         method=JaxDCVAE.modality_separation_loss))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    tm.modality_separation_loss(zt, torch.from_numpy(midx)).backward()
    assert torch.isfinite(zt.grad).all()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgrad), atol=1e-5)
    assert np.isfinite(np.asarray(jgrad)).all()


# ---------------------------------------------------------------- towers ---- #


@pytest.fixture(scope="module")
def lpips_pair():
    jl = jperc.LPIPSLoss(dtype=jnp.float32)
    variables = jl.init(jax.random.PRNGKey(11), 64)
    net = tperc.LPIPSNet()
    net.load_state_dict(from_jax_params(variables["params"], net))
    return jl, variables, net.eval().requires_grad_(False)


@pytest.mark.parametrize("size, channels", [(64, 3), (32, 3), (32, 1)])
def test_lpips_value_and_recon_grad_match_jax(lpips_pair, size, channels):
    jl, variables, net = lpips_pair
    inp = np.tanh(_np(7, 2, size, size, channels))
    rec = np.tanh(_np(8, 2, size, size, channels))
    want, want_grad = jax.value_and_grad(lambda r: jl(variables, jnp.asarray(inp), r))(jnp.asarray(rec))
    rt = torch.from_numpy(rec).requires_grad_(True)
    got = tperc.LPIPSLoss()(net, torch.from_numpy(inp), rt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want_grad), atol=1e-4)
    assert not any(p.requires_grad for p in net.parameters())


def _clip_pair(encoder):
    jl = jperc.BiomedCLIPLoss(encoder=encoder, dtype=jnp.float32)
    if encoder == "vit":
        jl.module = JaxCLIPViT(**SMALL_VIT)
        net = CLIPViT(**SMALL_VIT)
    else:
        net = tperc.SimpleCLIPEncoder()
    variables = jl.init(jax.random.PRNGKey(13))
    net.load_state_dict(from_jax_params(variables["params"], net))
    return jl, variables, net.eval().requires_grad_(False)


@pytest.mark.parametrize("encoder", ["vit", "simple"])
def test_biomedclip_value_and_recon_grad_match_jax_with_the_cubic_resize(encoder):
    jl, variables, net = _clip_pair(encoder)
    img = np.tanh(_np(9, 2, 32, 32, 3))
    rec = np.tanh(_np(10, 2, 32, 32, 3))
    want, want_grad = jax.value_and_grad(lambda r: jl(variables, jnp.asarray(img), rec=r))(jnp.asarray(rec))
    rt = torch.from_numpy(rec).requires_grad_(True)
    got = tperc.BiomedCLIPLoss(encoder=encoder)(net, torch.from_numpy(img), rt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want_grad), atol=1e-4)


@pytest.mark.parametrize(
    "n_in, n_out, method", [(16, 64, "linear"), (32, 224, "cubic"), (28, 224, "cubic"), (9, 5, "cubic"),
                            (12, 7, "linear")],
)
def test_resize_matches_jax_image_resize(n_in, n_out, method):
    x = _np(11, 2, n_in, n_in, 3)
    want = jax.image.resize(jnp.asarray(x), (2, n_out, n_out, 3), method=method)
    got = tperc.resize(torch.from_numpy(x), n_out, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cubic_resize_is_not_torch_bicubic():
    x = torch.from_numpy(_np(12, 1, 32, 32, 1))
    ours = tperc.resize(x, 224, "cubic")
    theirs = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(224, 224), mode="bicubic", align_corners=False
    ).permute(0, 2, 3, 1)
    assert (ours - theirs).abs().max() > 1e-3  # a = -0.5 against a = -0.75


@pytest.mark.parametrize("tower", ["lpips", "vit", "simple"])
def test_converter_maps_every_full_width_tower_leaf_once(tower):
    if tower == "lpips":
        jmod, tmod, x = jperc.LPIPSNet(), tperc.LPIPSNet(), (jnp.zeros((1, 64, 64, 3)),) * 2
    elif tower == "vit":
        jmod, tmod, x = JaxCLIPViT(), CLIPViT(), (jnp.zeros((1, 224, 224, 3)),)
    else:
        jmod, tmod, x = jperc.SimpleCLIPEncoder(), tperc.SimpleCLIPEncoder(), (jnp.zeros((1, 224, 224, 3)),)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *x)["params"]
    expected = {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    plan = plan_jax_params(shapes, expected)
    assert len(plan) == len(expected) == len(jax.tree_util.tree_leaves(shapes))
    transforms = {name: t for _, name, t in plan}
    if tower == "vit":
        assert transforms["block_11.attn.qkv.weight"] == "dense"
        assert transforms["patch_embed.weight"] == "conv" and transforms["proj"] is None
        assert expected["block_0.attn.qkv.weight"] == (2304, 768)


def test_frozen_tower_init_is_seeded_and_frozen():
    a = tperc.LPIPSLoss().init(3)
    b = tperc.LPIPSLoss().init(3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not any(p.requires_grad for p in a.parameters()) and not a.training
    np.testing.assert_allclose(a.lin1.numpy(), 1.0 / 192)


# ----------------------------------------------------------------- graft ---- #


def _write_npz(path, variables, extra=None):
    """A JAX tower init written as the export script writes one: flat
    `params/...` keys, no download."""
    from flax import traverse_util

    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(variables, sep="/").items()}
    np.savez(path, **flat, **(extra or {}))
    return str(path)


def _graft_pair(tower, tmp_path):
    """(JAX loss, its grafted variables, the port's tower grafted from the
    same npz). The npz comes from a JAX init under another seed than the
    one each package's random tower starts from."""
    from medvae_tpu_torch.losses.graft import graft_npz

    if tower == "lpips":
        src = jperc.LPIPSLoss(dtype=jnp.float32).init(jax.random.PRNGKey(5), 64)
        path = _write_npz(tmp_path / "lpips.npz", src, {"params/stale/kernel": np.zeros(3)})
        jl = jperc.LPIPSLoss(weights_path=path, dtype=jnp.float32)
        variables = jl.init(jax.random.PRNGKey(0), 64)
        net = tperc.LPIPSLoss().init(11)
    else:
        jl = jperc.BiomedCLIPLoss(encoder=tower, dtype=jnp.float32)
        if tower == "vit":
            jl.module = JaxCLIPViT(**SMALL_VIT)
        path = _write_npz(tmp_path / f"{tower}.npz", jl.init(jax.random.PRNGKey(6)),
                          {"params/stale/kernel": np.zeros(3)})
        jl._weights_path = path
        variables = jl.init(jax.random.PRNGKey(1))
        net = tperc.init_tower(CLIPViT(**SMALL_VIT) if tower == "vit" else tperc.SimpleCLIPEncoder(), 13)
    return jl, variables, graft_npz(net, path, tower), path


@pytest.mark.parametrize("tower", ["lpips", "vit", "simple"])
def test_grafted_tower_matches_the_jax_graft(tower, tmp_path, capsys):
    jl, variables, net, _ = _graft_pair(tower, tmp_path)
    assert "ignored unmatched keys: ['params/stale/kernel']" in capsys.readouterr().out
    if tower == "lpips":
        a, b = np.tanh(_np(21, 2, 64, 64, 3)), np.tanh(_np(22, 2, 64, 64, 3))
        want = np.asarray(jl.module.apply(variables, jnp.asarray(a), jnp.asarray(b)))
        got = net(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    else:
        x = _np(23, 2, 224, 224, 3)
        want = np.asarray(jl.module.apply(variables, jnp.asarray(x)))
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not any(p.requires_grad for p in net.parameters())


def test_make_frozen_reads_both_weight_paths(tmp_path):
    from medvae_tpu_torch.train.step import make_frozen

    _, _, lpips, lpips_path = _graft_pair("lpips", tmp_path)
    _, _, clip, clip_path = _graft_pair("simple", tmp_path)
    cfg = {"type": "disentangled_vae", "perceptual_weight": 0.1, "biomedclip_weight": 0.1,
           "clip_encoder": "simple"}
    random = make_frozen(cfg, "cpu")
    frozen = make_frozen({**cfg, "weights_path": lpips_path, "clip_weights_path": clip_path}, "cpu")
    for key, want, first in (("lpips", lpips, "alex.conv1.weight"), ("clip", clip, "Conv_0.weight")):
        got = frozen[key].state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.state_dict().items()), key
        assert not torch.equal(got[first], random[key].state_dict()[first]), key


def test_graft_without_a_matching_key_raises_in_both_packages(tmp_path):
    from medvae_tpu.losses.graft import graft_npz as jax_graft
    from medvae_tpu_torch.losses.graft import graft_npz

    path = str(tmp_path / "wrong.npz")
    np.savez(path, **{"alex/conv1/kernel": np.zeros((11, 11, 3, 64)), "params/nope": np.zeros(2)})
    with pytest.raises(ValueError, match="matched 0 of 2"):
        graft_npz(tperc.LPIPSLoss().init(0), path, "LPIPS")
    with pytest.raises(ValueError, match="matched 0 of 2"):
        jax_graft(jperc.LPIPSLoss().init(jax.random.PRNGKey(0), 64), path, "LPIPS")
