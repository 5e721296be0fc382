"""The port's training ops against the JAX package: the flash-attention
backward (plain path of kernels B1-lse, B2, B3, the two passes of their
Hopper instance, and the autograd Function), the
optimizer chain and schedules, and the on-device augmentation.

The JAX flash kernels run in Pallas interpret mode, as tests/test_flash_attention.py
runs them, with 32-row blocks so that n = 96 takes 3x3 blocks. Inputs are made
with numpy from a seed and handed to both packages. The CUDA kernels run only on
the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medvae_tpu.data import pipeline as jpipe
from medvae_tpu.ops import attention as jattn
from medvae_tpu.ops import flash_attention as jfa
from medvae_tpu.train import optim as joptim
from medvae_tpu_torch.data import pipeline as tpipe
from medvae_tpu_torch.ops import flash_attention as tfa
from medvae_tpu_torch.train import optim as toptim


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_MAX_BLOCK", 32)  # n=96 -> 3x3 blocks
    with pltpu.force_tpu_interpret_mode():
        yield


def _arrays(seed, count, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(count)]


# --------------------------------------------------------------- flash ---- #


def test_flash_function_grads_match_jax_flash_grads(interpret):
    q, k, v = _arrays(0, 3, (2, 96, 128))

    def jloss(q, k, v):
        return jnp.sum(jnp.tanh(jfa.flash_attention(q, k, v)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    torch.tanh(tfa.FlashAttention.apply(*leaves)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4)


def test_flash_lse_matches_jax_forward_kernel(interpret):
    q, k, v = _arrays(1, 3, (2, 96, 128))
    _, jlse = jfa._flash_fwd_kernel(*map(jnp.asarray, (q, k, v)))
    o, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert lse.shape == (2, 96) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse[..., 0]), atol=1e-5)
    np.testing.assert_array_equal(
        o.numpy(), tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_versions_match_jax_backward_kernels(interpret, dtype):
    q, k, v, g = _arrays(2, 4, (2, 96, 128))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv)
    delta = (tg.float() * o.float()).sum(-1)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v, g)] + [
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy())
    ]
    jdk, jdv = jfa._flash_dkv_kernel(*jargs)
    jdq = jfa._flash_dq_kernel(*jargs)
    dk, dv = tfa.flash_dkv_plain(tq, tk, tv, tg, lse, delta)
    dq = tfa.flash_dq_plain(tq, tk, tv, tg, lse, delta)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == tdt
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_backward_wrappers_use_plain_versions_on_cpu_and_count_nothing():
    q, k, v, g = map(torch.from_numpy, _arrays(3, 4, (1, 40, 64)))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    delta = (g * o).sum(-1)
    before = dict(tfa.launches)
    ref_dk, ref_dv = tfa.flash_dkv_plain(q, k, v, g, lse, delta)
    ref_dq = tfa.flash_dq_plain(q, k, v, g, lse, delta)
    for got, want in zip(tfa.flash_bwd(q, k, v, g, lse, delta), (ref_dq, ref_dk, ref_dv)):
        assert torch.equal(got, want)
    assert tfa.launches == before


def _bwd_inputs(seed, shape, dtype):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _arrays(seed, 4, shape))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v)
    return q, k, v, g, lse, (g.float() * o.float()).sum(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_plain_versions_equal_dkv_and_dq_plain_bit_for_bit(dtype):
    """The Hopper backward's two passes in PyTorch (planes, then dQ, dK, dV
    over them) are today's B2 and B3 plain versions bit for bit, at an n
    ragged against the planes' 64-row padding."""
    q, k, v, g, lse, delta = _bwd_inputs(4, (2, 100, 128), dtype)
    planes = tfa.flash_bwd_planes_plain(q, k, v, g, lse, delta)
    assert planes.shape == (2, 2, 128, 128) and planes.dtype == dtype
    dq, dk, dv = tfa.flash_bwd_grads_plain(planes, q, k, g)
    ref_dk, ref_dv = tfa.flash_dkv_plain(q, k, v, g, lse, delta)
    for got, want in ((dq, tfa.flash_dq_plain(q, k, v, g, lse, delta)), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pass_plain_versions_match_jax_backward_kernels(interpret, dtype):
    q, k, v, g = _arrays(5, 4, (2, 96, 128))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv)
    delta = (tg.float() * o.float()).sum(-1)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v, g)] + [
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy())
    ]
    jdk, jdv = jfa._flash_dkv_kernel(*jargs)
    jdq = jfa._flash_dq_kernel(*jargs)
    planes = tfa.flash_bwd_planes_plain(tq, tk, tv, tg, lse, delta)
    for got, want in zip(tfa.flash_bwd_grads_plain(planes, tq, tk, tg), (jdq, jdk, jdv)):
        assert got.dtype == tdt
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_backward_instance_is_chosen_by_dtype_alone():
    assert [tfa.flash_bwd_instance(c, torch.bfloat16) for c in (64, 192, 256, 512, 1024)] == ["wgmma_tma"] * 5
    assert tfa.flash_bwd_instance(512, torch.float32) == "fp32_fma"


@pytest.mark.parametrize("n, n_pad", [(1, 64), (63, 64), (64, 64), (100, 128), (1000, 1024), (3136, 3136)])
def test_planes_pad_n_to_64_and_hold_zeros_outside_n(n, n_pad):
    assert tfa.plane_shape(3, n) == (2, 3, n_pad, n_pad)
    if n > 100:
        return
    q, k, v, g, lse, delta = _bwd_inputs(6, (1, n, 64), torch.bfloat16)
    planes = tfa.flash_bwd_planes_plain(q, k, v, g, lse, delta)
    assert planes.shape == (2, 1, n_pad, n_pad)
    assert torch.count_nonzero(planes[:, :, n:]) == 0 and torch.count_nonzero(planes[:, :, :, n:]) == 0
    assert torch.count_nonzero(planes[0, :, :n, :n]) == n * n  # P > 0 inside


def test_attention_routes_grad_through_the_function_and_no_grad_to_serving(monkeypatch):
    from medvae_tpu_torch.ops import attention as tattn

    calls = []
    monkeypatch.setattr(tattn.FlashAttention, "apply", lambda q, k, v: calls.append("fn") or q)
    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v: calls.append("serve") or q)
    q = torch.zeros((1, 3136, 512), device="meta")
    tattn.attention(q, q, q)
    tattn.attention(q.requires_grad_(True), q, q)
    with torch.no_grad():
        tattn.attention(q, q, q)
    assert calls == ["serve", "fn", "serve"]


@pytest.mark.parametrize("n", [96, 100])
def test_reference_attention_grads_match_jax(n):
    q, k, v = _arrays(4, 3, (2, n, 64))
    from medvae_tpu_torch.ops import attention as tattn

    want = jax.grad(lambda *a: jnp.sum(jnp.tanh(jattn.reference_attention(*a))), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v))
    )
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    torch.tanh(tattn.reference_attention(*leaves)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-5)


# ------------------------------------------------------------ optimizer ---- #

OPTIMIZERS = {
    "adamw_cosine_wd": ({"type": "adamw", "lr": 1e-3, "weight_decay": 1e-4},
                        {"type": "cosine", "T_max": 4, "eta_min": 1e-5}),
    "adam_constant": ({"type": "adam", "lr": 1e-3, "betas": [0.8, 0.99]}, {"type": "constant"}),
    "adamw_step_wd": ({"type": "adamw", "lr": 1e-2, "weight_decay": 1e-2}, {"type": "step", "step_size": 2}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_chain_matches_optax(name):
    """Five updates, one with a NaN grad, the clip active (norm > 1) on even
    steps and inactive on odd ones."""
    opt_cfg, sched_cfg = OPTIMIZERS[name]
    rs = np.random.RandomState(5)
    params = [rs.randn(4, 3).astype(np.float32), rs.randn(5).astype(np.float32)]
    jtx = joptim.build_optimizer(opt_cfg, sched_cfg, gradient_clip_val=1.0)
    ttx = toptim.build_optimizer(opt_cfg, sched_cfg, gradient_clip_val=1.0)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    for i in range(5):
        scale = 2.0 if i % 2 == 0 else 0.05  # clip active on even steps
        grads = [rs.randn(*p.shape).astype(np.float32) * scale for p in params]
        if i == 1:
            grads[0][1, 2] = np.nan
        ju, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update([torch.from_numpy(g) for g in grads], tstate, tp)
        for p, u in zip(tp, tu):
            p.add_(u)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert tstate.count == 5


@pytest.mark.parametrize(
    "cfg",
    [None, {"type": "constant"}, {"type": "plateau"}, {"type": "step", "step_size": 2, "gamma": 0.5},
     {"type": "multistep", "milestones": [1, 3]}, {"type": "exponential", "gamma": 0.9},
     {"type": "cosine", "T_max": 3, "eta_min": 1e-4}],
)
def test_schedules_match_optax(cfg):
    want = joptim.build_schedule(cfg, 1e-2, steps_per_epoch=2)
    got = toptim.build_schedule(cfg, 1e-2, steps_per_epoch=2)
    for count in range(10):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_zero_nans_leaves_inf_and_grad_norm_is_optax_global_norm():
    grads = [np.array([1.0, np.nan, -2.0], np.float32), np.array([np.inf], np.float32)]
    params = [np.zeros(3, np.float32), np.zeros(1, np.float32)]
    jtx = joptim.build_optimizer({"type": "adam", "lr": 1.0}, None, gradient_clip_val=None)
    ttx = toptim.build_optimizer({"type": "adam", "lr": 1.0}, None, gradient_clip_val=None)
    want, _ = jtx.update([jnp.asarray(g) for g in grads], jtx.init([jnp.asarray(p) for p in params]))
    got, _ = ttx.update([torch.from_numpy(g) for g in grads], ttx.init([torch.from_numpy(p) for p in params]),
                        [torch.from_numpy(p) for p in params])
    assert got[0][1].item() == 0.0 and np.isnan(got[1].item())  # inf/inf in Adam, as in optax
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    arrays = _arrays(6, 2, (3, 4))
    np.testing.assert_allclose(
        toptim.global_norm([torch.from_numpy(a) for a in arrays]).item(),
        float(optax.global_norm([jnp.asarray(a) for a in arrays])), rtol=1e-6,
    )


# ----------------------------------------------------------- augmentation ---- #


def _jax_draws(rng, b):
    """The draws normalize_and_augment makes from `rng` (pipeline.py:400-413)."""
    k_flip, k_rot, k_bri, k_con = jax.random.split(rng, 4)
    return {
        "flip": np.asarray(jax.random.bernoulli(k_flip, 0.5, (b,))),
        "angle": np.asarray(jax.random.uniform(k_rot, (b,), minval=-10.0, maxval=10.0)),
        "brightness": np.asarray(jax.random.uniform(k_bri, (b, 1, 1, 1), minval=0.9, maxval=1.1)).reshape(b),
        "contrast": np.asarray(jax.random.uniform(k_con, (b, 1, 1, 1), minval=0.9, maxval=1.1)).reshape(b),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augmentation_with_jax_draws_matches_jax(dtype):
    b = 6
    u8 = np.random.RandomState(7).randint(0, 256, (b, 20, 20, 3)).astype(np.uint8)
    rng = jax.random.PRNGKey(3)
    draws = _jax_draws(rng, b)
    assert draws["flip"].any() and not draws["flip"].all()
    want = jpipe.normalize_and_augment(jnp.asarray(u8), rng, augment=True, dtype=getattr(jnp, dtype))
    got = tpipe.normalize_and_augment(
        torch.from_numpy(u8), augment=True, dtype=getattr(torch, dtype),
        draws={k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
    )
    assert str(got.dtype).split(".")[-1] == str(want.dtype)  # fp32: the rotation widens
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-5)


def test_rotate_batch_matches_jax():
    x = np.random.RandomState(8).rand(3, 17, 13, 2).astype(np.float32)
    angles = np.array([0.0, 0.1, -0.17], np.float32)
    want = jpipe._rotate_batch(jnp.asarray(x), jnp.asarray(angles))
    got = tpipe.rotate_batch(torch.from_numpy(x), torch.from_numpy(angles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_preprocess_masks_absent_channels_like_jax():
    from medvae_tpu.train.step import preprocess as jpre

    u8 = np.random.RandomState(9).randint(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    channels = np.array([1, 3, 3, 1], np.int32)
    want = jpre({"image_u8": jnp.asarray(u8), "channels": jnp.asarray(channels)}, None,
                augment=False, max_channels=3)
    got = tpipe.preprocess({"image_u8": torch.from_numpy(u8), "channels": torch.from_numpy(channels)},
                           augment=False, max_channels=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, ..., 1:] == 0).all()


def test_augmentation_draws_come_from_the_generator():
    u8 = torch.from_numpy(np.random.RandomState(10).randint(0, 256, (4, 8, 8, 3)).astype(np.uint8))
    run = lambda seed: tpipe.normalize_and_augment(  # noqa: E731
        u8, torch.Generator().manual_seed(seed), augment=True
    )
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
