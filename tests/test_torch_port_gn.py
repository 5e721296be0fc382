"""The port's fused GroupNorm + SiLU (kernels B6 and B7) on the CPU.

On the CPU the wrappers take their plain PyTorch versions, so these hold the
plain versions, the functions the CUDA kernels are held to on the card,
against the JAX package's Pallas kernels run as tests/test_ops.py runs them:
in Pallas interpret mode with the backend gate opened and MEDVAE_FUSED_GN=1.
The JAX kernels take NHWC and the port NCHW; inputs come from numpy seeds.
Tolerances: forward 1e-5 and backward 2e-4, the JAX package's own bars
(tests/test_ops.py:73,107); the switch on against off in a ResnetBlock, fp32,
1e-5 on the output and the input gradient and 1e-5 relative L2 on each
parameter gradient.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medvae_tpu.ops import groupnorm_swish as jgn
from medvae_tpu_torch.config.models import init_weights
from medvae_tpu_torch.nn.blocks import ResnetBlock
from medvae_tpu_torch.ops import groupnorm_swish as gs

EPS = 1e-6
# (b, c, h, w, groups): cg = 1, 2 and 3, and odd h·w
CASES = [(2, 32, 6, 6, 32), (2, 64, 4, 4, 32), (3, 96, 3, 3, 32), (2, 32, 5, 5, 16),
         (1, 8, 7, 7, 8)]


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, gate open."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jgn, "_on_tpu", lambda: True)
    monkeypatch.setenv("MEDVAE_FUSED_GN", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(case, seed):
    b, c, h, w, groups = case
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, c, h, w) * 2 + 0.5).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    g = rs.randn(b, c, h, w).astype(np.float32)
    return x, scale, bias, g, groups


def _nhwc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("case", CASES)
def test_b6_plain_version_matches_the_jax_kernel(interpret, case):
    x, scale, bias, _, groups = _inputs(case, 0)
    want = jgn._fwd_kernel(_nhwc(x), jnp.asarray(scale), jnp.asarray(bias), groups, EPS)
    got = gs.group_norm_swish_plain(*map(torch.from_numpy, (x, scale, bias)), groups, EPS)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_b7_plain_version_matches_the_jax_kernel(interpret, case):
    x, scale, bias, g, groups = _inputs(case, 1)
    jdx, jds, jdb = jgn._bwd_kernel(_nhwc(x), jnp.asarray(scale), jnp.asarray(bias), _nhwc(g),
                                    groups, EPS)
    tx, ts, tb, tg = map(torch.from_numpy, (x, scale, bias, g))
    mean, rstd = gs.group_stats_plain(tx, groups, EPS)
    dx, ds, db = gs.group_norm_swish_bwd_plain(tx, ts, tb, tg, mean, rstd)
    np.testing.assert_allclose(dx.numpy().transpose(0, 2, 3, 1), np.asarray(jdx), atol=2e-4)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=2e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=2e-4)


@pytest.mark.parametrize("case", CASES[:3])
def test_function_cpu_route_passes_gradcheck_in_float64(case):
    x, scale, bias, _, groups = _inputs(case, 2)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, scale, bias)]
    assert torch.autograd.gradcheck(
        lambda a, s, b: gs.GroupNormSwish.apply(a, s, b, groups, EPS), leaves
    )


def test_plain_statistics_are_torch_group_norm():
    x, scale, bias, _, groups = _inputs(CASES[2], 3)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    want = torch.nn.functional.silu(torch.nn.functional.group_norm(tx, groups, ts, tb, EPS))
    np.testing.assert_allclose(gs.group_norm_swish_plain(tx, ts, tb, groups, EPS).numpy(),
                               want.numpy(), atol=1e-5)


def test_bf16_plain_version_rounds_once_after_fp32_silu():
    """In bf16 the kernel's function takes SiLU in fp32 and casts once (the
    JAX kernel's order), one rounding away from the default path's
    GroupNorm -> bf16 -> SiLU."""
    x, scale, bias, _, groups = _inputs(CASES[0], 4)
    tx = torch.from_numpy(x).bfloat16()
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    got = gs.group_norm_swish_plain(tx, ts, tb, groups, EPS)
    fp32 = gs.group_norm_swish_plain(tx.float(), ts, tb, groups, EPS)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fp32.bfloat16())


@pytest.fixture
def block_pair():
    """A ResnetBlock 32 -> 64 with lecun-normal convs and GroupNorm scales
    and biases away from 1 and 0."""
    block = init_weights(ResnetBlock(32, 64), seed=0)
    rs = np.random.RandomState(6)
    with torch.no_grad():
        for norm in (block.norm1, block.norm2):
            c = norm.weight.shape[0]
            norm.weight.copy_(torch.from_numpy((rs.rand(c) + 0.5).astype(np.float32)))
            norm.bias.copy_(torch.from_numpy((rs.randn(c) * 0.1).astype(np.float32)))
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 32, 8, 8).astype(np.float32))
    return block, x


def _run_block(block, x, fused, monkeypatch):
    monkeypatch.setenv("MEDVAE_FUSED_GN", "1" if fused else "0")
    block.zero_grad()
    xin = x.clone().requires_grad_(True)
    out = block(xin)
    out.square().sum().backward()
    return out.detach(), xin.grad, {n: p.grad.clone() for n, p in block.named_parameters()}


def test_resnet_block_switch_on_matches_off(block_pair, monkeypatch):
    block, x = block_pair
    before = dict(gs.launches)
    off = _run_block(block, x, False, monkeypatch)
    on = _run_block(block, x, True, monkeypatch)
    assert gs.launches == before  # the CPU route launches nothing
    np.testing.assert_allclose(on[0].numpy(), off[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(on[1].numpy(), off[1].numpy(), atol=1e-5)
    # parameter gradients are sums over batch and space, held per leaf by
    # relative L2: the two paths sum in different orders in fp32
    for name in off[2]:
        rel = float(torch.linalg.vector_norm(on[2][name] - off[2][name])
                    / torch.linalg.vector_norm(off[2][name]))
        assert rel <= 1e-5, (name, rel)


def test_gate_is_opt_in_and_needs_whole_groups(monkeypatch):
    x = torch.randn(1, 32, 4, 4)
    w, b = torch.ones(32), torch.zeros(32)
    monkeypatch.delenv("MEDVAE_FUSED_GN", raising=False)
    assert gs.fused_group_norm_swish_or_none(x, w, b, 32, EPS) is None
    monkeypatch.setenv("MEDVAE_FUSED_GN", "1")
    assert gs.fused_group_norm_swish_or_none(x, w, b, 12, EPS) is None
    out = gs.fused_group_norm_swish_or_none(x, w, b, 32, EPS)
    torch.testing.assert_close(out, gs.group_norm_swish_plain(x, w, b, 32, EPS))
    # no h·w·c cap: the TPU gate refuses this shape, the port's takes it
    big = torch.zeros(1, 128, 64, 64)
    assert gs.fused_group_norm_swish_or_none(big, torch.ones(128), torch.zeros(128), 32, EPS) is not None


@pytest.mark.parametrize("rows, hw, want", [(32 * 128, 224 * 224, 3), (128, 224 * 224, 49),
                                            (4096 * 32, 28 * 28, 1), (4096 * 128, 7 * 7, 1)])
def test_reductions_split_rows_only_when_too_few_fill_the_card(rows, hw, want):
    assert gs.splits_for(rows, hw, sms=132) == want
