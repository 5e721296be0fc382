"""The model options a reference checkpoint can carry, in the port against
the JAX package on the CPU: linear attention (`use_linear_attn` /
`attn_type: linear`) in every family, and the ConditionalVAE's `inject` and
`film` conditioning.

Small models (hidden 32, ch_mult (1, 2), one res block, attention at 16²,
16² inputs, latent 4, fp32) are initialised by the JAX package and their
params go through `from_jax_params` into the port; inputs, one-hot
conditions and noise are made with numpy from seeds and handed to both.
Tolerances: outputs 2e-4, loss terms 2e-4 and gradients 5e-4 (the port's
fp32 bars against the JAX package).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import BetaVAE as JaxBetaVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.nn import blocks as jblocks
from medvae_tpu.train import step as jstep
from medvae_tpu.train.trainer import build_model as jax_build_model
from medvae_tpu_torch.compat.jax_params import from_jax_grads, from_jax_params, plan_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.nn import blocks as tblocks
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep

SMALL = dict(latent_dim=4, hidden_channels=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(16,), resolution=16)
DIS_SMALL = dict(num_modalities=5, shared_latent_dim=2, modality_latent_dim=2, hidden_channels=32,
                 ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=16)
FAMILIES = {"BaseVAE": JaxBaseVAE, "BetaVAE": JaxBetaVAE, "ConditionalVAE": JaxCVAE,
            "DisentangledConditionalVAE": JaxDCVAE}
TOL, GRAD_TOL = 2e-4, 5e-4
B = 4
LOSS = {"type": "vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0}
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "model" / "conditional_vae.yaml"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------- linear attention ---- #


@pytest.mark.parametrize("heads, dim_head", [(4, 16), (1, 64)])
def test_linear_attention_matches_jax(heads, dim_head):
    x = np.random.RandomState(0).randn(2, 8, 6, 64).astype(np.float32)
    jmod = jblocks.LinearAttention(dim=64, heads=heads, dim_head=dim_head)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tblocks.LinearAttention(64, heads=heads, dim_head=dim_head)
    tmod.load_state_dict(from_jax_params(params, tmod))
    assert tmod.to_qkv.bias is None
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_lin_attn_block_is_single_head_with_no_norm_or_residual_like_jax():
    x = np.random.RandomState(1).randn(2, 4, 4, 32).astype(np.float32)
    jmod = jblocks.make_attn(32, attn_type="linear")
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tblocks.make_attn(32, "linear")
    assert isinstance(tmod, tblocks.LinAttnBlock) and tmod.heads == 1 and tmod.dim_head == 32
    # flax nests the block's LinearAttention under `attn`; the reference's
    # LinAttnBlock is a LinearAttention, so its keys have no such level
    tmod.load_state_dict(from_jax_params(params["attn"], tmod))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tblocks.make_attn(32, "sparse")


def _init(cls, channels, **extra):
    kw = dict(DIS_SMALL if cls is JaxDCVAE else dict(SMALL, input_channels=channels), **extra)
    jm = cls(**kw)
    x = jnp.zeros((2, 16, 16, channels))
    args = [x] + ([jnp.zeros((2,), jnp.int32)] if cls is JaxDCVAE else
                  [jnp.zeros((2, 12))] if cls is JaxCVAE else [])
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, *args)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm = build_model(dict(kw, _target_=cls.__name__), "fp32", "cpu")
    tm.load_state_dict(from_jax_params(params, tm))
    return jm, params, tm


def _inputs(name, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    midx = np.array([0, 3, 1, 4])
    cond = {"ConditionalVAE": [np.eye(12, dtype=np.float32)[midx]],
            "DisentangledConditionalVAE": [midx.astype(np.int32)]}.get(name, [])
    return x, cond, rs.randn(B, 8, 8, 4).astype(np.float32)  # the flagship's 2 + 2


# each family once, the two spellings of the option taken in turn
@pytest.mark.parametrize("name, option", [
    ("BaseVAE", {"use_linear_attn": True}), ("BetaVAE", {"attn_type": "linear"}),
    ("ConditionalVAE", {"attn_type": "linear"}), ("DisentangledConditionalVAE", {"use_linear_attn": True}),
])
def test_every_family_with_linear_attention_matches_jax(name, option):
    jm, params, tm = _init(FAMILIES[name], 3, **option)
    assert any(isinstance(m, tblocks.LinAttnBlock) for m in tm.modules())
    assert not any(isinstance(m, tblocks.AttnBlock) for m in tm.modules())
    x, cond, noise = _inputs(name)
    want = jax.jit(lambda p, *a, noise: jm.apply({"params": p}, *a, noise=noise))(
        params, jnp.asarray(x), *map(jnp.asarray, cond), noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *map(torch.from_numpy, cond), noise=torch.from_numpy(noise))
    for key in ("reconstruction", "mean", "logvar", "z"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, err_msg=key)


# ------------------------------------------------------- inject and film ---- #


@pytest.fixture(scope="module", params=["inject", "film"])
def conditioned(request):
    jm, params, tm = _init(JaxCVAE, 3, condition_method=request.param)
    return request.param, jm, params, tm


def test_conditioning_params_and_encoder_width(conditioned):
    method, _, _, tm = conditioned
    names = tm.state_dict()
    assert tm.encoder.conv_in.weight.shape[1] == 3  # only concat widens conv_in
    assert not any(k.startswith("condition_proj") for k in names)
    temb = sorted(k for k in names if ".temb_proj.weight" in k)
    if method == "inject":
        assert names["condition_embedding.layers_0.weight"].shape == (512, 12)
        assert names["condition_embedding.layers_2.weight"].shape == (512, 512)
        # the encoder's down blocks and both mid blocks; never the decoder
        assert temb == ["encoder.down.0.block.0.temb_proj.weight", "encoder.down.1.block.0.temb_proj.weight",
                        "encoder.mid.block_1.temb_proj.weight", "encoder.mid.block_2.temb_proj.weight"]
    else:
        assert not temb
        assert names["film_0.scale_transform.weight"].shape == (32, 12)
        assert names["film_1.shift_transform.weight"].shape == (64, 12)


def test_conditioned_forward_matches_jax(conditioned):
    _, jm, params, tm = conditioned
    x, cond, noise = _inputs("ConditionalVAE", seed=1)
    want = jax.jit(lambda p, *a, noise: jm.apply({"params": p}, *a, noise=noise))(
        params, jnp.asarray(x), *map(jnp.asarray, cond), noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *map(torch.from_numpy, cond), noise=torch.from_numpy(noise))
        other = tm(torch.from_numpy(x), torch.from_numpy(np.roll(cond[0], 1, axis=0)),
                   noise=torch.from_numpy(noise))
    for key in ("reconstruction", "mean", "logvar", "z"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, err_msg=key)
    assert (got["mean"] - other["mean"]).abs().max() > 1e-4  # the condition reaches the encoder
    # unconditioned, both encode the image alone
    jmu, _ = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        tmu, _ = tm.encode(torch.from_numpy(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=TOL)


def test_conditioned_step_loss_and_gradients_match_jax(conditioned):
    _, jm, params, _ = conditioned
    rs = np.random.RandomState(2)
    midx = np.array([2, 0, 5, 11])
    batch = {"image_u8": rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
             "modality_onehot": np.eye(12, dtype=np.float32)[midx],
             "modality_idx": midx.astype(np.int32),
             "channels": np.full((B,), 3, np.int32),
             "noise": rs.randn(B, 8, 8, 4).astype(np.float32)}
    jcrit, forward = jstep.make_criterion(LOSS, jm), jstep.make_forward_fn(jm)

    def jloss(p, b):
        x = jstep.preprocess(b, None, augment=False, max_channels=3)
        out = jcrit({}, forward(p, x, b, {"sample": jax.random.PRNGKey(0)}), x)
        return out["loss"], out

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(dict(SMALL, input_channels=3, condition_method=conditioned[0],
                             _target_="ConditionalVAE"), "fp32", "cpu", train=True)
    model.load_state_dict(from_jax_params(params, model))
    state = tstate.create_train_state(model, toptim.build_optimizer({"type": "adam", "lr": 1e-3},
                                                                    {"type": "constant"}))
    terms, grads = tstep.build_loss_and_grads(model, LOSS)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "recon_loss", "kl_loss"):
        np.testing.assert_allclose(float(terms[key]), float(jterms[key]), rtol=0, atol=TOL, err_msg=key)
    want = from_jax_grads(jax.tree_util.tree_map(np.asarray, jgrads), model)
    got = dict(zip(state.params, grads))
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=GRAD_TOL, rtol=0,
                                   err_msg=name)
    conditioning = [n for n in got if n.startswith(("film_", "condition_embedding")) or "temb_proj" in n]
    assert conditioning and all(got[n].abs().max() > 0 for n in conditioning)


@pytest.mark.parametrize("extra", [{"condition_method": "inject"}, {"condition_method": "film"},
                                   {"condition_method": "concat", "use_linear_attn": True}])
def test_converter_covers_the_full_size_conditioned_trees(extra):
    """Every leaf of the 224² ConditionalVAE config's JAX tree with the
    option set maps onto the port model once (shapes only)."""
    cfg = yaml.safe_load(CONFIG.read_text())
    cfg.update(extra)
    jm = jax_build_model(cfg, precision="bf16", use_pallas=False)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 224, 224, 1)), jnp.zeros((1, 12)))["params"]
    tm = build_model(cfg, "bf16", "meta")
    expected = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    plan = plan_jax_params(shapes, expected)
    assert len(plan) == len(expected) == len(jax.tree_util.tree_leaves(shapes))


def test_unknown_condition_method_raises():
    with pytest.raises(ValueError, match="condition_method"):
        build_model(dict(SMALL, _target_="ConditionalVAE", condition_method="cross"), "fp32", "meta")
