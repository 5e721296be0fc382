"""The public names the port adds for the JAX package's surface, against
`medvae_tpu` on the CPU: `utils.gradient_penalty`, `ema_update` and
`count_parameters`, `core.RngStream`, `set_seed` and `default_policy`,
`nn.GroupNormSwish` and `group_norm`, `ops.fused_attention_or_none`, and
the trunk's last options (`Decoder(give_pre_end, tanh_out)`,
`ResnetBlock(conv_shortcut)`) with params carried by `from_jax_params`.

Inputs come from a numpy seed; bars are the port's fp32 ones: 2e-4 on
outputs, 5e-4 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.core import precision as jprecision
from medvae_tpu.core import rng as jrng
from medvae_tpu.nn import blocks as jblocks
from medvae_tpu.nn.discriminator import NLayerDiscriminator as JaxDisc
from medvae_tpu.nn.encoder_decoder import Decoder as JaxDecoder
from medvae_tpu.ops import attention as jattention
from medvae_tpu.utils import training_utils as jutils
from medvae_tpu_torch import core, nn as tnn, ops, utils
from medvae_tpu_torch.compat.jax_params import from_jax_disc_variables, from_jax_grads, from_jax_params
from medvae_tpu_torch.core import threefry

TOL, GRAD_TOL = 2e-4, 5e-4
DISC = dict(input_nc=3, ndf=8, n_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float32))
    return float((got.detach().float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ------------------------------------------------------------ utils ---- #


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_gradient_penalty_alpha_is_jaxs_draw_bit_for_bit(seed):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (6, 1, 1, 1)))
    got = threefry.uniform(threefry.prng_key(seed), (6, 1, 1, 1)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def penalty_runs():
    """JAX's and the port's WGAN-GP through the same PatchGAN weights (eval
    mode: running statistics), on the same images and key; JAX's gradient
    of the penalty with respect to the discriminator's params."""
    rs = np.random.RandomState(0)
    real = rs.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    fake = rs.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    jdisc = JaxDisc(**DISC)
    variables = _np(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((2, 16, 16, 3)), train=False))
    key = jax.random.PRNGKey(11)

    def penalty(params):
        apply = lambda x: jdisc.apply({**variables, "params": params}, x, train=False)  # noqa: E731
        return jutils.gradient_penalty(apply, jnp.asarray(real), jnp.asarray(fake), key)

    want, jgrads = jax.value_and_grad(penalty)(variables["params"])
    disc = tnn.NLayerDiscriminator(**DISC)
    disc.load_state_dict(from_jax_disc_variables(variables, disc))
    got = utils.gradient_penalty(disc, torch.from_numpy(real), torch.from_numpy(fake), threefry.prng_key(11))
    got.backward()
    again = utils.gradient_penalty(disc, torch.from_numpy(real), torch.from_numpy(fake), threefry.prng_key(11))
    return {"want": float(want), "got": got, "again": again, "disc": disc,
            "jgrads": from_jax_grads(_np(jgrads), disc)}


def test_gradient_penalty_matches_jax(penalty_runs):
    r = penalty_runs
    assert r["want"] > 0
    assert abs(float(r["got"].detach()) - r["want"]) <= TOL * max(1.0, abs(r["want"]))
    assert torch.equal(r["got"].detach(), r["again"].detach())


def test_gradient_penalty_trains_the_discriminator_as_jax(penalty_runs):
    r = penalty_runs
    grads = dict(r["disc"].named_parameters())
    assert set(r["jgrads"]) == set(grads)
    for name, want in r["jgrads"].items():
        # autograd leaves None where the penalty does not reach (the last
        # conv's bias), JAX zeros
        got = grads[name].grad if grads[name].grad is not None else torch.zeros_like(grads[name])
        assert float((got - want).abs().max()) <= GRAD_TOL * max(1.0, float(want.abs().max())), name
    # in eval mode the input gradient depends on no bias (leaky ReLU's slope
    # is piecewise constant), only on the weights and the norms' scales
    assert all(float(g.grad.abs().max()) > 0 for n, g in grads.items() if n.endswith("weight"))


def test_ema_update_and_count_parameters_give_jaxs_values():
    rs = np.random.RandomState(1)
    ema = {"a": rs.randn(5, 3).astype(np.float32), "b": {"c": rs.randn(7).astype(np.float32)}}
    params = {"a": rs.randn(5, 3).astype(np.float32), "b": {"c": rs.randn(7).astype(np.float32)}}
    for decay in (0.999, 0.9):
        want = _np(jutils.ema_update(jax.tree_util.tree_map(jnp.asarray, ema),
                                     jax.tree_util.tree_map(jnp.asarray, params), decay))
        t = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)  # noqa: E731
        got = utils.ema_update(t(ema), t(params), decay)
        assert got["a"].numpy().tobytes() == want["a"].tobytes()
        assert got["b"]["c"].numpy().tobytes() == want["b"]["c"].tobytes()
    as_list = utils.ema_update([torch.from_numpy(ema["a"])], [torch.from_numpy(params["a"])])
    assert as_list[0].numpy().tobytes() == np.asarray(
        jutils.ema_update(jnp.asarray(ema["a"]), jnp.asarray(params["a"]))).tobytes()
    assert utils.count_parameters(jax.tree_util.tree_map(torch.from_numpy, params)) == jutils.count_parameters(params)
    jdisc = JaxDisc(**DISC)
    jparams = jdisc.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    assert utils.count_parameters(tnn.NLayerDiscriminator(**DISC)) == jutils.count_parameters(jparams)


# ------------------------------------------------------------- core ---- #


@pytest.mark.parametrize("name", ["train", "dropout", "sample", ""])
def test_rng_stream_gives_jaxs_keys(name):
    root = 1234
    jstream = jrng.RngStream(jax.random.PRNGKey(root), name)
    stream = core.RngStream(core.set_seed(root), name)
    for step in (0, 1, 17, 2**31 - 1):
        assert stream(step) == tuple(int(w) for w in np.asarray(jstream(step)))
    assert stream.split(4) == [tuple(int(w) for w in k) for k in np.asarray(jstream.split(4))]
    assert core.set_seed(root) == tuple(int(w) for w in np.asarray(jax.random.PRNGKey(root)))


@pytest.mark.parametrize("mixed", [True, False])
def test_default_policy_casts_as_jax(mixed):
    rs = np.random.RandomState(2)
    tree = {"x": rs.randn(3).astype(np.float32), "i": np.arange(3, dtype=np.int32),
            "nested": [rs.randn(2).astype(np.float32), (np.arange(2, dtype=np.int32),)]}
    jpol, pol = jprecision.default_policy(mixed), core.default_policy(mixed)
    ttree = {"x": torch.from_numpy(tree["x"]), "i": torch.from_numpy(tree["i"]),
             "nested": [torch.from_numpy(tree["nested"][0]), (torch.from_numpy(tree["nested"][1][0]),)]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for jcast, cast in ((jpol.cast_to_compute, pol.cast_to_compute), (jpol.cast_to_output, pol.cast_to_output)):
        want, got = jcast(jtree), cast(ttree)
        pairs = [(want["x"], got["x"]), (want["i"], got["i"]), (want["nested"][0], got["nested"][0]),
                 (want["nested"][1][0], got["nested"][1][0])]
        assert isinstance(got["nested"][1], tuple)
        for w, g in pairs:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))


# --------------------------------------------------------- nn, ops ---- #


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("c", [32, 64])
def test_group_norm_swish_module_matches_jax(fused, c, monkeypatch):
    """The `nn` export is the module; with the switch on, on the CPU, it
    takes the autograd Function over B6/B7's plain versions."""
    monkeypatch.setenv("MEDVAE_FUSED_GN", fused)
    rs = np.random.RandomState(c)
    x = rs.randn(2, 6, 6, c).astype(np.float32)
    g = rs.randn(2, 6, 6, c).astype(np.float32)
    jm = jblocks.GroupNormSwish(num_channels=c)
    params = {"scale": (1 + 0.1 * rs.randn(c)).astype(np.float32), "bias": (0.1 * rs.randn(c)).astype(np.float32)}

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * g)

    want = np.asarray(jm.apply({"params": params}, x))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    m = tnn.GroupNormSwish(c)
    assert isinstance(m, torch.nn.GroupNorm) and m.num_groups == min(32, c) and m.eps == 1e-6
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(params["scale"]))
        m.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = m(xt)
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    assert _max_rel(out.permute(0, 2, 3, 1), want) <= TOL
    assert _max_rel(xt.grad.permute(0, 2, 3, 1), jgx) <= GRAD_TOL
    assert _max_rel(m.weight.grad, jgp["scale"]) <= GRAD_TOL
    assert _max_rel(m.bias.grad, jgp["bias"]) <= GRAD_TOL
    norm = tnn.group_norm(c)
    assert type(norm) is not tnn.GroupNormSwish and (norm.num_groups, norm.eps) == (min(32, c), 1e-6)


@pytest.mark.parametrize("shape", [(2, 256, 64), (2, 49, 16), (1, 3136, 512)])
def test_fused_attention_or_none_is_none_on_the_cpu_as_jaxs(shape):
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    assert jattention.fused_attention_or_none(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)) is None
    assert ops.fused_attention_or_none(*(torch.from_numpy(a) for a in (q, k, v))) is None


class _Wrap(torch.nn.Module):
    """Holds a port Decoder as `decoder`, where from_jax_params maps codec names."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder


DECODER = dict(ch=8, out_ch=1, num_res_blocks=1, attn_resolutions=(8,), resolution=16, z_channels=4,
               ch_mult=(1, 2))


@pytest.mark.parametrize("option", ["give_pre_end", "tanh_out"])
def test_decoder_options_match_jax(option):
    rs = np.random.RandomState(3)
    z = rs.randn(2, 8, 8, 4).astype(np.float32)
    jdec = JaxDecoder(**DECODER, in_channels=1, **{option: True})
    params = _np(jdec.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"])
    want = np.asarray(jdec.apply({"params": params}, jnp.asarray(z)))
    dec = tnn.Decoder(**DECODER, **{option: True}).eval()
    wrap = _Wrap(dec)
    wrap.load_state_dict(from_jax_params({"decoder": params}, wrap))
    with torch.no_grad():
        got = dec(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _max_rel(got, want) <= TOL
    if option == "tanh_out":
        assert float(got.abs().max()) < 1
    else:
        assert got.shape[-1] == 8 and not hasattr(dec, "norm_out")


def test_resnet_block_conv_shortcut_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 8).astype(np.float32)
    jblock = jblocks.ResnetBlock(in_channels=8, out_channels=16, conv_shortcut=True)
    params = _np(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    assert "conv_shortcut" in params and "nin_shortcut" not in params
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = tnn.ResnetBlock(8, 16, conv_shortcut=True).eval()
    block.load_state_dict(from_jax_params(params, block))
    assert block.conv_shortcut.kernel_size == (3, 3) and block.nin_shortcut is None
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _max_rel(got, want) <= TOL


def test_scatter_plot_draws_each_point_in_its_labels_color(tmp_path):
    """The walkthroughs' latent projection without matplotlib: the extreme
    points land at the canvas's margins, each in its label's color."""
    from medvae_tpu_torch.utils.visualization import _PALETTE, read_png_size, scatter_plot

    canvas = scatter_plot(np.array([[0.0, 0.0], [1.0, 1.0], [0.5, 0.25]]), np.array([0, 1, 12]),
                          str(tmp_path / "s.png"), size=64, radius=1)
    assert read_png_size(str(tmp_path / "s.png")) == (64, 64)
    margin = 4
    assert (canvas[63 - margin, margin] == _PALETTE[0]).all()
    assert (canvas[margin, 63 - margin] == _PALETTE[1]).all()
    assert (canvas[63 - (margin + 14), margin + 28] == _PALETTE[2]).all()
    assert (canvas == 255).all(axis=-1).mean() > 0.95
