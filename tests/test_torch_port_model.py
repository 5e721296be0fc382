"""The port's flagship model (medvae_tpu_torch) against the JAX package.

A small DisentangledConditionalVAE (hidden 32, ch_mult (1, 2), one res block,
attention at the top level, 16² inputs, 5 modalities, fp32) is initialised by
the JAX package; its params go through `from_jax_params` into the port. Inputs
and latents are made with numpy from a seed and handed to both. The converter
is also checked against the full-width flagship tree, from shapes only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.train.trainer import build_model as jax_build_model
from medvae_tpu_torch.compat.jax_params import from_jax_params, plan_jax_params
from medvae_tpu_torch.config.models import FLAGSHIP, build_model, init_weights

SMALL = dict(
    num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, hidden_channels=32,
    ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=16,
)
TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    jm = JaxDCVAE(**SMALL)
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    midx = np.arange(5, dtype=np.int32)
    variables = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(x), jnp.asarray(midx),
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm = build_model(dict(SMALL, _target_="DisentangledConditionalVAE"), "fp32", "cpu")
    tm.load_state_dict(from_jax_params(params, tm))

    def japply(method):
        return jax.jit(functools.partial(jm.apply, {"params": params}, method=method))

    return jm, japply, tm, x, midx


def test_encode_matches_jax(pair):
    jm, japply, tm, x, midx = pair
    jmu, jlv = japply(jm.encode)(jnp.asarray(x), jnp.asarray(midx))
    tmu, tlv = tm.encode(torch.from_numpy(x), torch.from_numpy(midx))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=TOL)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), atol=TOL)


def test_decode_with_routed_heads_for_every_modality_matches_jax(pair):
    jm, japply, tm, _, midx = pair
    z = np.random.RandomState(1).randn(5, 8, 8, 8).astype(np.float32)
    want = japply(jm.decode)(jnp.asarray(z), jnp.asarray(midx))
    got = tm.decode(torch.from_numpy(z), torch.from_numpy(midx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # the heads route: another modality gives another image
    other = tm.decode(torch.from_numpy(z), torch.full((5,), 4))
    assert (other - got).abs().max() > 1e-4


def test_posterior_mean_reconstruct_matches_jax(pair):
    jm, japply, tm, x, midx = pair
    jmu, _ = japply(jm.encode)(jnp.asarray(x), jnp.asarray(midx))
    want = japply(jm.decode)(jmu, jnp.asarray(midx))
    tmu, _ = tm.encode(torch.from_numpy(x), torch.from_numpy(midx))
    got = tm.decode(tmu, torch.from_numpy(midx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_sample_conditional_shift_matches_jax(pair):
    jm, japply, tm, _, midx = pair
    z = np.random.RandomState(2).randn(5, 8, 8, 8).astype(np.float32)
    shifted = z + ((midx.astype(np.float32) - 2.0) * 0.3)[:, None, None, None]
    want = japply(jm.decode)(jnp.asarray(shifted), jnp.asarray(midx))
    got = tm.sample_conditional(5, torch.from_numpy(midx), noise=torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_reparameterize_matches_jax(pair):
    jm, japply, tm, x, midx = pair
    mu, logvar = (np.random.RandomState(s).randn(2, 8, 8, 8).astype(np.float32) for s in (5, 6))
    noise = np.random.RandomState(7).randn(2, 8, 8, 8).astype(np.float32)
    want = japply(jm.reparameterize)(jnp.asarray(mu), jnp.asarray(logvar), noise=jnp.asarray(noise))
    got = tm.reparameterize(*map(torch.from_numpy, (mu, logvar, noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_latent_partition_matches_jax(pair):
    jm, japply, tm, _, _ = pair
    z = np.random.RandomState(3).randn(2, 8, 8, 8).astype(np.float32)
    js, jmod = japply(jm.partition_latent)(jnp.asarray(z))
    ts, tmod = tm.partition_latent(torch.from_numpy(z))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tmod.numpy(), np.asarray(jmod))
    back = tm.reconstruct_latent(ts, tmod)
    want = japply(jm.reconstruct_latent)(js, jmod)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_flagship_config_equals_the_shipped_yaml():
    import yaml
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "configs/model/disentangled_conditional_vae.yaml"
    assert FLAGSHIP == yaml.safe_load(path.read_text())["model"]


def test_converter_covers_the_full_width_flagship_tree():
    """Every leaf of the 224² flagship's JAX param tree maps onto the port
    model exactly once with the right shape; shapes only, no memory used."""
    jm = jax_build_model(FLAGSHIP, precision="bf16", use_pallas=False)
    shapes = jax.eval_shape(
        jm.init,
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, 224, 224, 3), jnp.float32), jnp.zeros((1,), jnp.int32),
    )["params"]
    tm = build_model(FLAGSHIP, "bf16", "meta")
    expected = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    plan = plan_jax_params(shapes, expected)
    assert len(plan) == len(expected) == len(jax.tree_util.tree_leaves(shapes))
    names = {name for _, name, _ in plan}
    assert "encoder.down.2.attn.1.q.weight" in names
    assert "decoder.up.2.attn.2.proj_out.weight" in names
    assert expected["heads_conv2.weight"] == (15, 3, 3, 3)


def _head_params():
    params = {"heads_conv1": {"kernel": np.zeros((3, 3, 3, 15)), "bias": np.zeros(15)}}
    expected = {"heads_conv1.weight": (15, 3, 3, 3), "heads_conv1.bias": (15,)}
    return params, expected


@pytest.mark.parametrize("fault", ["leftover", "unknown", "shape", "unmapped"])
def test_converter_raises_instead_of_loading_partially(fault):
    params, expected = _head_params()
    if fault == "leftover":
        expected["heads_conv2.weight"] = (15, 3, 3, 3)
    elif fault == "unknown":
        params["extra_kernel"] = np.zeros((3, 3))
    elif fault == "shape":
        expected["heads_conv1.bias"] = (14,)
    else:
        params["heads_conv1"]["embedding"] = np.zeros((5, 64))
    with pytest.raises((KeyError, ValueError)):
        plan_jax_params(params, expected)
    if fault == "leftover":
        del expected["heads_conv2.weight"]
        assert len(plan_jax_params(_head_params()[0], expected)) == 2


def test_precision_policy_stores_convs_in_the_compute_dtype():
    cfg = dict(SMALL, _target_="DisentangledConditionalVAE")
    half = build_model(cfg, "bf16", "cpu")
    assert half.dtype == torch.bfloat16
    assert half.encoder.conv_in.weight.dtype == torch.bfloat16
    assert half.encoder.norm_out.weight.dtype == torch.float32
    assert half.in_proj_kernel_0.dtype == torch.float32
    assert build_model(cfg, "fp32", "cpu").dtype == torch.float32
    with pytest.raises(ValueError):
        build_model(cfg, "fp16", "cpu")


def test_bf16_model_tracks_fp32_model():
    cfg = dict(SMALL, _target_="DisentangledConditionalVAE")
    full = init_weights(build_model(cfg, "fp32", "cpu"), seed=0)
    half = build_model(cfg, "bf16", "cpu")
    half.load_state_dict(full.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    m = torch.tensor([1, 3])
    a = full.decode(full.encode(x, m)[0], m)
    b = half.decode(half.encode(x, m)[0].to(torch.bfloat16), m).float()
    assert torch.isfinite(b).all()
    assert ((a - b).norm() / a.norm()).item() < 5e-2
