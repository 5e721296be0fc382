"""The port's CUDA kernels on the card (`cuda` marker; skipped without a GPU).

The kernels have no CPU mode, so these run only on the machine with the
H100. This file imports nothing of JAX, so that it runs there without the
JAX test harness:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from medvae_tpu_torch.ops import attention as at
from medvae_tpu_torch.ops import flash_attention as fa
from medvae_tpu_torch.ops import groupnorm_swish as gs

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# (max abs, relative L2) by dtype, as in chip_smoke.py: the bf16 bar is a
# fraction of a typical output, so a kernel that drops a key tile fails it
TOLERANCE = {torch.bfloat16: (4e-3, 1e-2), torch.float32: (1e-4, 1e-4)}
# the backward kernels' bars, as in chip_smoke.py: bf16 relative L2 1e-2 and
# max abs 15 % of the gradient's std; fp32 1e-4 for both
GRAD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
GRAD_ABS_OF_STD = {torch.bfloat16: 0.15, torch.float32: None}

SHAPES = [((2, 1000, 512), torch.bfloat16), ((2, 784, 1024), torch.bfloat16),
          ((1, 200, 64), torch.bfloat16), ((1, 300, 512), torch.float32),
          ((1, 100, 1024), torch.float32)]


def _qkv(gen, shape, dtype, count=3):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(count)]


def _rel(got, want):
    got, want = got.double(), want.double()
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()


def _assert_grad_close(got, want, dtype, what):
    err = (got.double() - want.double()).abs().max().item()
    rel = _rel(got, want)
    frac = GRAD_ABS_OF_STD[dtype]
    bar = frac * want.double().std().item() if frac else 1e-4
    assert torch.isfinite(got).all(), what
    assert err <= bar and rel <= GRAD_REL[dtype], (what, err, bar, rel)


@pytest.mark.parametrize("shape, dtype", SHAPES)
def test_flash_kernel_matches_plain_version(gen, shape, dtype):
    q, k, v = _qkv(gen, shape, dtype)
    before = fa.launches["flash_fwd"]
    got = fa.flash_attention(q, k, v).double()
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 1
    want = fa.flash_attention_plain(q, k, v).double()
    tol_abs, tol_rel = TOLERANCE[dtype]
    err = (got - want).abs().max().item()
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    assert err <= tol_abs and rel <= tol_rel, (err, rel)


@pytest.mark.parametrize("shape, dtype", SHAPES)
def test_flash_lse_and_backward_kernels_match_plain_versions(gen, shape, dtype):
    q, k, v, g = _qkv(gen, shape, dtype, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    tol_abs, tol_rel = TOLERANCE[dtype]
    assert (o.double() - o_ref.double()).abs().max().item() <= tol_abs
    delta = (g.float() * o.float()).sum(-1)
    before = dict(fa.launches)
    dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert fa.launches["flash_bwd"] == before["flash_bwd"] + 1
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse, delta)
    dq_ref = fa.flash_dq_plain(q, k, v, g, lse, delta)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.dtype == dtype
        _assert_grad_close(got, want, dtype, name)


@pytest.mark.parametrize("shape, dtype", [((2, 300, 128), torch.float32),
                                          ((2, 520, 512), torch.bfloat16)])
def test_flash_function_grads_match_autograd_of_plain_forward(gen, shape, dtype):
    q, k, v, w = _qkv(gen, shape, dtype, 4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    # a non-contiguous incoming gradient, as AttnBlock's transpose gives
    out = fa.FlashAttention.apply(*leaves).transpose(1, 2)
    (out.float() * w.transpose(1, 2).float()).sum().backward()
    ref = fa.flash_attention_fwd_plain(*ref_leaves)[0].transpose(1, 2)
    (ref.float() * w.transpose(1, 2).float()).sum().backward()
    for name, a, b in zip("qkv", leaves, ref_leaves):
        _assert_grad_close(a.grad, b.grad, dtype, "d" + name)


def test_wgmma_descriptors_and_p_fragments_match_matmul(gen):
    """One tile of each product of B1's Hopper instance (flash_fwd.cu:
    medvae_flash_wgmma_selftest): S = q·kᵀ with both operands K-major in
    swizzled shared memory, and bf16(S)·v with v read as a transposed
    (MN-major) operand and bf16(S) taken from registers, held against the
    same product with bf16(S) staged through shared memory."""
    from medvae_tpu_torch.ops import _build

    q = torch.randn((64, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((32, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((32, 128), generator=gen, device="cuda").bfloat16()
    s = torch.empty((64, 32), device="cuda")
    o, o_staged = torch.empty((64, 128), device="cuda"), torch.empty((64, 128), device="cuda")
    fn = _build.load("flash_fwd").medvae_flash_wgmma_selftest
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 7, ctypes.c_int
    err = fn(*(t.data_ptr() for t in (q, k, v, s, o, o_staged)), torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err}"
    torch.cuda.synchronize()
    s_ref = q.double() @ k.double().T
    o_ref = s.bfloat16().double() @ v.double()
    assert _rel(s, s_ref) <= 1e-5, _rel(s, s_ref)
    assert _rel(o, o_ref) <= 1e-5, _rel(o, o_ref)
    assert torch.equal(o, o_staged)


# the Hopper instance's head dims, and n ragged against both its 64-row query
# tile and its 32-key stage
WGMMA_C = [128, 256, 384, 512]
WGMMA_N = [1, 63, 1000, 3136]


@pytest.mark.parametrize("c", WGMMA_C)
@pytest.mark.parametrize("n", WGMMA_N)
def test_flash_wgmma_instance_matches_plain_version(gen, n, c):
    assert fa.flash_fwd_instance(c, torch.bfloat16) == "wgmma_tma"
    b = 1 if n == 3136 else 2
    q, k, v = _qkv(gen, (b, n, c), torch.bfloat16)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    before = fa.launches["flash_fwd"]
    o = fa.flash_attention(q, k, v)
    o_lse, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 2
    tol_abs, tol_rel = TOLERANCE[torch.bfloat16]
    for got in (o, o_lse):
        assert torch.isfinite(got).all()
        err = (got.double() - o_ref.double()).abs().max().item()
        assert err <= tol_abs and _rel(got, o_ref) <= tol_rel, (err, _rel(got, o_ref))
    assert torch.equal(o, o_lse)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_flash_wgmma_instance_repeats_bit_for_bit(gen):
    q, k, v = _qkv(gen, (4, 1000, 512), torch.bfloat16)
    o1, lse1 = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_flash_c1024_stays_on_the_mma_sync_instance(gen):
    assert fa.flash_fwd_instance(1024, torch.bfloat16) == "mma_sync"
    assert fa.flash_fwd_instance(192, torch.bfloat16) == "mma_sync"
    q, k, v = _qkv(gen, (2, 784, 1024), torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    tol_abs, tol_rel = TOLERANCE[torch.bfloat16]
    assert (o.double() - o_ref.double()).abs().max().item() <= tol_abs
    assert _rel(o, o_ref) <= tol_rel
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_flash_wrapper_raises_on_the_card_instead_of_falling_back(gen):
    """The raw serving launch refuses what B1 does not take (the op
    `fa.flash_attention` copies its operands contiguous first, and
    test_serving_ops_raise_on_the_card_instead_of_falling_back holds its
    refusals)."""
    def fn(*a):
        return fa.flash_attention_fwd(*a, want_lse=False)

    q = torch.randn((1, 64, 128), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        fn(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fn(q, q.cpu(), q)
    t = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fn(t, t, t)


def test_backward_wrappers_raise_on_the_card_instead_of_falling_back(gen):
    q = torch.randn((1, 64, 128), generator=gen, device="cuda")
    rows = torch.zeros((1, 64), device="cuda")
    before = dict(fa.launches)
    fn = fa.flash_bwd
    with pytest.raises(TypeError):
        fn(q, q, q, q.bfloat16(), rows, rows)
    with pytest.raises(ValueError, match="fp32"):
        fn(q, q, q, q, rows.double(), rows)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2), rows, rows)
    with pytest.raises(ValueError, match="multiple of 64"):
        wide = torch.zeros((1, 64, 96), device="cuda")
        fn(wide, wide, wide, wide, rows, rows)
    assert fa.launches == before


def test_flash_bwd_operand_forms_and_stores_match_matmul(gen):
    """The Hopper backward's operand forms and store path (flash_bwd.cu:
    medvae_flash_bwd_selftest): x·z and xᵀ·z on m64n256 and m64n128 with B
    MN-major over 4 and 2 boxes side by side (pass (b)'s products, A K-major
    then read transposed), and bf16(x·z[:, :128]) written through swizzled
    staging boxes and TMA stores (pass (a)'s planes)."""
    from medvae_tpu_torch.ops import _build

    x = torch.randn((64, 64), generator=gen, device="cuda").bfloat16()
    z = torch.randn((64, 256), generator=gen, device="cuda").bfloat16()
    o256, o256t = torch.empty((64, 256), device="cuda"), torch.empty((64, 256), device="cuda")
    o128, o128t = torch.empty((64, 128), device="cuda"), torch.empty((64, 128), device="cuda")
    st = torch.zeros((64, 128), device="cuda", dtype=torch.bfloat16)
    fn = _build.load("flash_bwd").medvae_flash_bwd_selftest
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 8, ctypes.c_int
    err = fn(*(t.data_ptr() for t in (x, z, o256, o256t, o128, o128t, st)),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err}"
    torch.cuda.synchronize()
    xz, xtz = x.double() @ z.double(), x.double().T @ z.double()
    for got, want, what in ((o256, xz, "x z n256"), (o256t, xtz, "x^T z n256"),
                            (o128, xz[:, :128], "x z n128"), (o128t, xtz[:, :128], "x^T z n128")):
        assert _rel(got, want) <= 1e-5, (what, _rel(got, want))
    assert torch.equal(st, o128.bfloat16())


# chip_smoke.py's bf16 shapes that are not its timed one, ragged n against the
# planes' 64-row padding and the 128-row tiles, and every column block of pass
# (b) (256, 128 and 64 columns)
WGMMA_BWD_SHAPES = [(2, 1000, 512), (3, 1000, 256), (2, 784, 1024), (1, 63, 128), (2, 200, 384),
                    (1, 130, 64), (1, 300, 192), (1, 3136, 512)]


@pytest.mark.parametrize("shape", WGMMA_BWD_SHAPES)
def test_flash_bwd_wgmma_instance_matches_plain_versions(gen, shape):
    b, n, c = shape
    assert fa.flash_bwd_instance(c, torch.bfloat16) == "wgmma_tma"
    q, k, v, g = _qkv(gen, shape, torch.bfloat16, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    before = dict(fa.launches)
    dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert fa.launches == {**before, "flash_bwd": before["flash_bwd"] + 1}
    # the same launch into a NaN-filled scratch: pass (a) writes every element
    # of the planes, zeros outside n x n, and the gradients are the wrapper's
    planes = torch.full(fa.plane_shape(b, n), float("nan"), dtype=torch.bfloat16, device="cuda")
    grads = tuple(torch.empty_like(q) for _ in range(3))
    fa._launch("flash_bwd", (q, k, v, g, lse, delta, *grads, planes), q)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(grads, (dq, dk, dv)))
    assert torch.count_nonzero(planes[:, :, n:]) == 0 and torch.count_nonzero(planes[:, :, :, n:]) == 0
    want_planes = fa.flash_bwd_planes_plain(q, k, v, g, lse, delta)
    for i, name in enumerate(("P", "dS")):
        _assert_grad_close(planes[i, :, :n, :n], want_planes[i, :, :n, :n], torch.bfloat16, name)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse, delta)
    dq_ref = fa.flash_dq_plain(q, k, v, g, lse, delta)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.dtype == torch.bfloat16
        _assert_grad_close(got, want, torch.bfloat16, name)


def test_flash_bwd_wgmma_instance_repeats_bit_for_bit(gen):
    q, k, v, g = _qkv(gen, (4, 1000, 512), torch.bfloat16, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    first = fa.flash_bwd(q, k, v, g, lse, delta)
    second = fa.flash_bwd(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_bwd_instance_names_each_head_dim(gen):
    assert [fa.flash_bwd_instance(c, torch.bfloat16) for c in (256, 512, 1024)] == ["wgmma_tma"] * 3
    assert fa.flash_bwd_instance(512, torch.float32) == "fp32_fma"
    # the FMA instance: one launch, no planes
    q, k, v, g = _qkv(gen, (1, 100, 256), torch.float32, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    before = dict(fa.launches)
    dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert fa.launches == {**before, "flash_bwd": before["flash_bwd"] + 1}
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse, delta)
    for name, got, want in (("dq", dq, fa.flash_dq_plain(q, k, v, g, lse, delta)), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        _assert_grad_close(got, want, torch.float32, name)


# ---------------------------------------------------------------- B6, B7 ---- #

# the shapes chip_smoke.py holds B6 and B7 to: the 28² CVAE's bs-4096 levels
# (cg = 1 at 28²x32; h·w = 49 at 7²x128), the flagship's widest level at bs 32
# and at bs 1 (clusters), an fp32 level of the flagship, and a ragged fp32
# shape with cg = 3
GN_SHAPES = [((4096, 32, 28, 28), torch.bfloat16), ((4096, 128, 7, 7), torch.bfloat16),
             ((32, 128, 224, 224), torch.bfloat16), ((1, 128, 224, 224), torch.bfloat16),
             ((2, 1024, 28, 28), torch.float32), ((3, 96, 9, 9), torch.float32)]


def _gn_inputs(gen, shape, dtype):
    """x with an offset (|mean| > std in some groups), gamma around 1, beta
    around 0, and an incoming gradient."""
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    w = torch.rand((c,), generator=gen, device="cuda") + 0.5
    b = torch.randn((c,), generator=gen, device="cuda") * 0.1
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return x, w, b, g, min(32, c)


def _assert_gn_fwd_close(got, want, dtype):
    """fp32: relative L2 1e-5 and max abs 1e-4; bf16: at most one rounding
    apart elementwise (2^-7 |p| + 1e-6) and relative L2 2e-3."""
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert _rel(got, want) <= 1e-5 and (got - want).abs().max().item() <= 1e-4
    else:
        assert bool(((got - want).abs() <= 2.0**-7 * want.abs() + 1e-6).all())
        assert _rel(got, want) <= 2e-3


@pytest.mark.parametrize("shape, dtype", GN_SHAPES)
def test_gn_swish_kernels_match_plain_versions(gen, shape, dtype):
    x, w, b, g, groups = _gn_inputs(gen, shape, dtype)
    before = dict(gs.launches)
    y, mean, rstd = gs.group_norm_swish_fwd(x, w, b, groups, 1e-6)
    dx, dw, db = gs.group_norm_swish_bwd(x, w, b, g, mean, rstd)
    torch.cuda.synchronize()
    assert gs.launches == {k: v + 1 for k, v in before.items()}
    y_ref, mean_ref, rstd_ref = gs.group_norm_swish_fwd_plain(x, w, b, groups, 1e-6)
    assert y.dtype == dtype and dx.dtype == dtype
    _assert_gn_fwd_close(y, y_ref, dtype)
    assert _rel(mean, mean_ref) <= 1e-5 and _rel(rstd, rstd_ref) <= 1e-5
    dx_ref, dw_ref, db_ref = gs.group_norm_swish_bwd_plain(x, w, b, g, mean, rstd)
    if dtype == torch.float32:
        for got, want in ((dx, dx_ref), (dw, dw_ref), (db, db_ref)):
            assert _rel(got, want) <= 1e-4
    else:
        _assert_grad_close(dx, dx_ref, dtype, "dx")
        assert _rel(dw, dw_ref) <= 1e-3 and _rel(db, db_ref) <= 1e-3


def test_gn_swish_backward_is_deterministic(gen):
    """No atomics: the same inputs give the same bits."""
    x, w, b, g, groups = _gn_inputs(gen, (8, 64, 56, 56), torch.bfloat16)
    _, mean, rstd = gs.group_norm_swish_fwd(x, w, b, groups, 1e-6)
    first = gs.group_norm_swish_bwd(x, w, b, g, mean, rstd)
    second = gs.group_norm_swish_bwd(x, w, b, g, mean, rstd)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_swish_function_grads_match_autograd_of_plain_forward(gen, dtype):
    x, w, b, g, groups = _gn_inputs(gen, (4, 64, 16, 16), dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = torch.autograd.grad(gs.GroupNormSwish.apply(*leaves, groups, 1e-6), leaves, g)
    want = torch.autograd.grad(gs.group_norm_swish_plain(*ref_leaves, groups, 1e-6), ref_leaves, g)
    bar = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b_ in zip(got, want):
        assert _rel(a, b_) <= bar


def test_gn_swish_wrappers_raise_on_the_card_instead_of_falling_back(gen):
    x, w, b, g, _ = _gn_inputs(gen, (2, 64, 8, 8), torch.float32)
    _, mean, rstd = gs.group_norm_swish_fwd(x, w, b, 32, 1e-6)
    before = dict(gs.launches)
    with pytest.raises(TypeError):
        gs.group_norm_swish_fwd(x.half(), w, b, 32, 1e-6)
    with pytest.raises(ValueError, match="groups"):
        gs.group_norm_swish_fwd(x, w, b, 24, 1e-6)
    with pytest.raises(ValueError, match="fp32"):
        gs.group_norm_swish_fwd(x, w.bfloat16(), b, 32, 1e-6)
    t = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        gs.group_norm_swish_fwd(t, w, b, 32, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        gs.group_norm_swish_bwd(x, w, b, g.transpose(2, 3).contiguous().transpose(2, 3), mean, rstd)
    with pytest.raises(TypeError):
        gs.group_norm_swish_bwd(x, w, b, g.bfloat16(), mean, rstd)
    with pytest.raises(ValueError, match="fp32"):
        gs.group_norm_swish_bwd(x, w, b, g, mean.double(), rstd)
    assert gs.launches == before


# each instance at shapes it takes by default and on plans changed from the
# default (an "instance" forced through plan_for, other fields by
# dataclasses.replace): resident (8, 16 or 32 lanes a group: the CVAE's 28²
# and 7² levels, several spans a block, vectors that straddle two rows at 7²
# in bf16 and fp32; a ragged cg = 3 at odd h·w; a last span of plain loads
# (60 groups of 25 elements), alone and after a ring of bulk loads (48012
# groups, spans of 32); the block a group: the 128² BaseVAE's 16² x 1024
# level; three stages wrapping round the ring; fp32 B7's spans cut to what
# two stages hold), cluster (the flagship's 224² level at bs 1, its 56² x
# 512 level, unaligned groups of plain loads, cluster 8 at 224² and cluster 2
# at an fp32 112² level) and streamed (forced at a CVAE and a flagship shape)
GN_INSTANCE_CASES = [
    ((1024, 32, 28, 28), torch.bfloat16, {}),
    ((2048, 128, 7, 7), torch.bfloat16, {}),
    ((512, 64, 28, 28), torch.bfloat16, {}),
    ((64, 128, 7, 7), torch.float32, {}),
    ((8, 96, 7, 7), torch.bfloat16, {}),
    ((5, 12, 5, 5), torch.bfloat16, {}),
    ((5, 12, 5, 5), torch.float32, {}),
    ((5, 12, 5, 5), torch.bfloat16, {"groups_per_span": 8}),
    ((4001, 12, 5, 5), torch.bfloat16, {"groups_per_span": 32}),
    ((4, 1024, 16, 16), torch.bfloat16, {}),
    ((600, 96, 9, 9), torch.float32, {"stages": 3, "groups_per_span": 4}),
    ((64, 32, 32, 32), torch.float32, {}),
    ((1, 128, 224, 224), torch.bfloat16, {}),
    ((2, 512, 56, 56), torch.bfloat16, {}),
    ((2, 96, 123, 123), torch.float32, {}),
    ((2, 96, 123, 123), torch.bfloat16, {}),
    ((2, 128, 224, 224), torch.bfloat16, {"instance": "cluster", "cluster": 8}),
    ((2, 128, 112, 112), torch.float32, {"instance": "cluster", "cluster": 2}),
    ((1024, 32, 28, 28), torch.bfloat16, {"instance": "streamed"}),
    ((2, 128, 224, 224), torch.bfloat16, {"instance": "streamed"}),
]


def _gn_direct(x, w, b, g, groups, fwd_plan, bwd_plan):
    """B6 then B7 through `_launch` into outputs and workspace filled with
    NaN, so that an element a kernel leaves unwritten shows."""
    nan = lambda *shape: torch.full(shape, float("nan"), dtype=torch.float32, device="cuda")
    bsz, c = x.shape[:2]
    y, mean, rstd = torch.full_like(x, float("nan")), nan(bsz, groups), nan(bsz, groups)
    ws = gs._workspace(fwd_plan, x, groups, False).fill_(float("nan"))
    gs._launch("gn_swish_fwd", (x, w, b, y, mean, rstd, ws), x, groups, fwd_plan, 1e-6)
    dx, dw, db = torch.full_like(x, float("nan")), nan(c), nan(c)
    ws = gs._workspace(bwd_plan, x, groups, True).fill_(float("nan"))
    gs._launch("gn_swish_bwd", (x, g, w, b, mean, rstd, dx, dw, db, ws), x, groups, bwd_plan)
    torch.cuda.synchronize()
    return y, mean, rstd, dx, dw, db


def _gn_plans(x, groups, override):
    """B6's and B7's plans for x: plan_for's (with its forced "instance"),
    the other fields of `override` set by dataclasses.replace and the shared
    memory recounted."""
    fields = dict(override)
    instance = fields.pop("instance", None)
    length = x.shape[1] // groups * x.shape[2] * x.shape[3]
    plans = []
    for backward in (False, True):
        plan = dataclasses.replace(gs.plan_for(x, groups, backward, instance), **fields)
        plans.append(dataclasses.replace(plan, smem_bytes=gs.plan_smem(plan, length, x.element_size(),
                                                                       backward)))
    return tuple(plans)


@pytest.mark.parametrize("shape, dtype, override", GN_INSTANCE_CASES)
def test_gn_swish_instances_match_plain_versions(gen, shape, dtype, override):
    x, w, b, g, groups = _gn_inputs(gen, shape, dtype)
    fwd_plan, bwd_plan = _gn_plans(x, groups, override)
    if "instance" in override:
        assert fwd_plan.instance == bwd_plan.instance == override["instance"]
    y, mean, rstd, dx, dw, db = _gn_direct(x, w, b, g, groups, fwd_plan, bwd_plan)
    y_ref, mean_ref, rstd_ref = gs.group_norm_swish_fwd_plain(x, w, b, groups, 1e-6)
    _assert_gn_fwd_close(y, y_ref, dtype)
    assert _rel(mean, mean_ref) <= 1e-5 and _rel(rstd, rstd_ref) <= 1e-5
    dx_ref, dw_ref, db_ref = gs.group_norm_swish_bwd_plain(x, w, b, g, mean, rstd)
    if dtype == torch.float32:
        for got, want in ((dx, dx_ref), (dw, dw_ref), (db, db_ref)):
            assert torch.isfinite(got).all() and _rel(got, want) <= 1e-4
    else:
        _assert_grad_close(dx, dx_ref, dtype, "dx")
        assert _rel(dw, dw_ref) <= 1e-3 and _rel(db, db_ref) <= 1e-3


@pytest.mark.parametrize("shape, dtype, override", [GN_INSTANCE_CASES[i] for i in (0, 1, 7, 8, 9, 12, 14, 18)])
def test_gn_swish_instances_repeat_bit_for_bit(gen, shape, dtype, override):
    """No atomics, sums in a fixed order: B6 and B7 give the same bits twice."""
    x, w, b, g, groups = _gn_inputs(gen, shape, dtype)
    plans = _gn_plans(x, groups, override)
    first = _gn_direct(x, w, b, g, groups, *plans)
    second = _gn_direct(x, w, b, g, groups, *plans)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("shape, dtype, override", GN_INSTANCE_CASES)
def test_gn_swish_instance_names_the_plan_the_wrapper_launches(gen, shape, dtype, override):
    if override:
        pytest.skip("a forced plan is not the default instance")
    x = torch.empty(shape, dtype=dtype, device="cuda")
    groups = min(32, shape[1])
    for backward in (False, True):
        assert gs.gn_swish_instance(shape, dtype, backward) == gs.plan_for(x, groups, backward).instance


@pytest.mark.parametrize("shape, dtype, override", [c for c in GN_INSTANCE_CASES if c[1] == torch.bfloat16
                                                     and c[2].get("instance") != "streamed"])
def test_gn_swish_bf16_dx_is_one_rounding_of_fp32(gen, shape, dtype, override):
    """B7 forms dx in fp32 and rounds it once: its relative L2 from the plain
    version's fp32 dx stays within 1.1 times that of the rounding alone (a
    second bf16 rounding inside, of dz, gives about 1.41)."""
    x, w, b, g, groups = _gn_inputs(gen, shape, dtype)
    y, mean, rstd, dx, _, _ = _gn_direct(x, w, b, g, groups, *_gn_plans(x, groups, override))
    dx32 = gs.group_norm_swish_bwd_plain(x.float(), w, b, g.float(), mean, rstd)[0]
    assert _rel(dx, dx32) <= 1.1 * _rel(dx32.to(dtype), dx32)


def test_gn_swish_kernels_refuse_a_plan_whose_shared_memory_disagrees(gen):
    x, w, b, g, groups = _gn_inputs(gen, (4, 64, 8, 8), torch.bfloat16)
    plan = gs.plan_for(x, groups)
    bad = dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16)
    before = dict(gs.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        gs.group_norm_swish_fwd(x, w, b, groups, 1e-6, plan=bad)
    assert gs.launches == before


# ---------------------------------------------------------------- B4, B5 ---- #

# the shapes chip_smoke.py holds B4 and B5 to: the 128² BaseVAE's attention
# (64, 256, 1024), a narrower level, and ragged edges of the gate (n not a
# multiple of the tiles, odd channel counts, the largest n at c 64 and the
# largest c at n 128)
ATTN_SHAPES = [(64, 256, 1024), (64, 256, 512), (2, 144, 64), (3, 196, 96), (2, 863, 64),
               (2, 128, 2870)]


def _assert_attn_fwd_close(got, want, dtype):
    """fp32: max abs and relative L2 1e-5 (tests/test_ops.py:40); bf16: one
    rounding apart elementwise and relative L2 2e-3."""
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5 and _rel(got, want) <= 1e-5
    else:
        assert bool(((got - want).abs() <= 2.0**-7 * want.abs() + 1e-6).all())
        assert _rel(got, want) <= 2e-3


def _assert_attn_grad_close(got, want, dtype, what):
    """fp32: max abs and relative L2 1e-4 (tests/test_ops.py:59); bf16: the
    flash backward's bars."""
    if dtype == torch.float32:
        err = (got.double() - want.double()).abs().max().item()
        assert torch.isfinite(got).all() and err <= 1e-4 and _rel(got, want) <= 1e-4, (what, err)
    else:
        _assert_grad_close(got, want, dtype, what)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_kernels_match_plain_versions(gen, shape, dtype):
    q, k, v, g = _qkv(gen, shape, dtype, 4)
    before = dict(at.launches)
    o = at.fused_attention_fwd(q, k, v)
    dq, dk, dv = at.fused_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert at.launches == {k_: v_ + 1 for k_, v_ in before.items()}
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    _assert_attn_fwd_close(o, at.fused_attention_fwd_plain(q, k, v), dtype)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                               at.fused_attention_bwd_plain(q, k, v, g)):
        _assert_attn_grad_close(got, want, dtype, name)


def test_attention_backward_is_deterministic(gen):
    """No atomics: the same inputs give the same bits."""
    q, k, v, g = _qkv(gen, (8, 256, 1024), torch.bfloat16, 4)
    first = at.fused_attention_bwd(q, k, v, g)
    second = at.fused_attention_bwd(q, k, v, g)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("shape, dtype", [((4, 256, 1024), torch.bfloat16),
                                          ((2, 144, 96), torch.float32)])
def test_fused_attention_function_grads_match_autograd_of_plain_forward(gen, shape, dtype):
    q, k, v, w = _qkv(gen, shape, dtype, 4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    # a non-contiguous incoming gradient, as AttnBlock's transpose gives
    out = at.FusedAttention.apply(*leaves).transpose(1, 2)
    (out.float() * w.transpose(1, 2).float()).sum().backward()
    ref = at.fused_attention_fwd_plain(*ref_leaves).transpose(1, 2)
    (ref.float() * w.transpose(1, 2).float()).sum().backward()
    for name, a, b_ in zip("qkv", leaves, ref_leaves):
        _assert_attn_grad_close(a.grad, b_.grad, dtype, "d" + name)


def test_attention_wrappers_raise_on_the_card_instead_of_falling_back(gen):
    q = torch.randn((1, 128, 64), generator=gen, device="cuda")
    before = dict(at.launches)
    with pytest.raises(TypeError):
        at.fused_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        at.fused_attention_fwd(q, q.cpu(), q)
    assert at.uses_fused(863, 64) and not at.uses_fused(864, 64)
    assert at.fused_max_tokens() >= 863  # every n the gate admits
    with pytest.raises(ValueError, match="n <="):
        big = torch.zeros((1, at.fused_max_tokens() + 1, 64), device="cuda")
        at.fused_attention_fwd(big, big, big)
    t = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        at.fused_attention_bwd(q, q, q, t)
    with pytest.raises(TypeError):
        at.fused_attention_bwd(q, q, q, q.bfloat16())
    assert at.launches == before


# the Hopper instance (bf16, c % 64 == 0, n <= 256): the 128² BaseVAE's
# (64, 256, 1024), its narrower level, b down to 1, and n ragged against the
# 64-row tiles and the 256-key rows
WGMMA_ATTN_SHAPES = [(64, 256, 1024), (64, 256, 512), (1, 256, 1024), (8, 256, 1024), (3, 196, 128)]
# the instance each of ATTN_SHAPES takes in bf16 (fp32 always takes "fma"):
# c = 96 and 2870 are not multiples of 64, n = 863 is past 256
ATTN_INSTANCE = {(64, 256, 1024): "wgmma_tma", (64, 256, 512): "wgmma_tma", (2, 144, 64): "wgmma_tma",
                 (3, 196, 96): "fma", (2, 863, 64): "fma", (2, 128, 2870): "fma"}


def test_attention_instance_names_each_shape(gen):
    assert set(ATTN_INSTANCE) == set(ATTN_SHAPES)
    for (b, n, c), want in ATTN_INSTANCE.items():
        assert at.attention_instance(n, c, torch.bfloat16) == want, (b, n, c)
        assert at.attention_instance(n, c, torch.float32) == "fma", (b, n, c)
    for _, n, c in WGMMA_ATTN_SHAPES:
        assert at.attention_instance(n, c, torch.bfloat16) == "wgmma_tma"


def test_attention_wgmma_operand_forms_match_matmul(gen):
    """One tile of each operand form of the Hopper instance
    (attention.cu: medvae_attention_wgmma_selftest): x·yᵀ on m64n128 with
    both operands K-major, x·z with A K-major and B MN-major, xᵀ·z with A
    read transposed (MN-major), and the three bf16 terms of the fp32 x·yᵀ
    from registers times z, which must keep fp32 fidelity."""
    from medvae_tpu_torch.ops import _build

    x = torch.randn((64, 64), generator=gen, device="cuda").bfloat16()
    y = torch.randn((128, 64), generator=gen, device="cuda").bfloat16()
    z = torch.randn((64, 64), generator=gen, device="cuda").bfloat16()
    s = torch.empty((64, 128), device="cuda")
    o_k, o_t, o_r = (torch.empty((64, 64), device="cuda") for _ in range(3))
    fn = _build.load("attention").medvae_attention_wgmma_selftest
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 8, ctypes.c_int
    err = fn(*(t.data_ptr() for t in (x, y, z, s, o_k, o_t, o_r)), torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err}"
    torch.cuda.synchronize()
    xd, yd, zd = x.double(), y.double(), z.double()
    for name, got, want in (("s", s, xd @ yd.T), ("o_k", o_k, xd @ zd), ("o_t", o_t, xd.T @ zd),
                            ("o_r", o_r, s.double()[:, :64] @ zd)):
        assert _rel(got, want) <= 1e-6, (name, _rel(got, want))


@pytest.mark.parametrize("shape", WGMMA_ATTN_SHAPES)
def test_attention_wgmma_instance_matches_plain_versions(gen, shape):
    _, n, c = shape
    assert at.attention_instance(n, c, torch.bfloat16) == "wgmma_tma"
    q, k, v, g = _qkv(gen, shape, torch.bfloat16, 4)
    before = dict(at.launches)
    o = at.fused_attention_fwd(q, k, v)
    grads = at.fused_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert at.launches == {k_: v_ + 1 for k_, v_ in before.items()}
    _assert_attn_fwd_close(o, at.fused_attention_fwd_plain(q, k, v), torch.bfloat16)
    for name, got, want in zip(("dq", "dk", "dv"), grads, at.fused_attention_bwd_plain(q, k, v, g)):
        assert got.dtype == torch.bfloat16
        _assert_attn_grad_close(got, want, torch.bfloat16, name)


def test_attention_wgmma_instance_repeats_bit_for_bit(gen):
    """B4 and B5 on the Hopper instance: no atomics, fixed-order sums."""
    q, k, v, g = _qkv(gen, (8, 256, 1024), torch.bfloat16, 4)
    assert torch.equal(at.fused_attention_fwd(q, k, v), at.fused_attention_fwd(q, k, v))
    for a, b_ in zip(at.fused_attention_bwd(q, k, v, g), at.fused_attention_bwd(q, k, v, g)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("fused_gn", ["0", "1"])
def test_gan_step_gradients_repeat_bit_for_bit(gen, fused_gn, monkeypatch):
    """One GAN step's generator and discriminator gradients (a small concat
    ConditionalVAE in bf16, the fp32 PatchGAN and LPIPS tower), twice from
    the same weights, batch and generator: equal bit for bit, which exact
    resume on the card rests on (cuDNN kept to deterministic algorithms, the
    condition map resized by matrix products)."""
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.nn.discriminator import build_discriminator
    from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
    from medvae_tpu_torch.train.state import create_train_state
    from medvae_tpu_torch.train.step import build_gan_grads, make_frozen

    monkeypatch.setenv("MEDVAE_FUSED_GN", fused_gn)
    cfg = {"_target_": "ConditionalVAE", "input_channels": 3, "latent_dim": 8, "hidden_channels": 32,
           "ch_mult": [1, 2, 4], "num_res_blocks": 1, "attn_resolutions": [], "resolution": 28}
    loss = {"type": "lpips_discriminator", "pixel_factor": 1.0, "discriminator_iter_start": 0}
    weights = init_weights(build_model(cfg, "fp32", "cpu", train=True), seed=0).state_dict()
    disc_weights = build_discriminator(None, "cpu", seed=7).state_dict()
    frozen = make_frozen(loss, "cuda", seed=0)
    midx = torch.arange(16, device="cuda") % 5
    batch = {"image_u8": torch.randint(0, 256, (16, 28, 28, 3), generator=gen, device="cuda",
                                       dtype=torch.uint8),
             "modality_onehot": torch.nn.functional.one_hot(midx, 12).float(), "modality_idx": midx}

    def grads():
        model = build_model(cfg, "bf16", "cuda", train=True)
        model.load_state_dict(weights)
        disc = build_discriminator(None, "cuda", seed=0)
        disc.load_state_dict(disc_weights)
        opt = {"type": "adamw", "lr": 1e-4}
        state = create_train_state(model, build_optimizer(opt), frozen, disc=disc,
                                   disc_tx=discriminator_optimizer(opt))
        g, d, _ = build_gan_grads(model, disc, loss)(state, batch, torch.Generator("cuda").manual_seed(1))
        return g + d + list(disc.buffers())

    first, second = grads(), grads()
    assert len(first) == len(second) > 100
    assert [i for i, (a, b) in enumerate(zip(first, second)) if not torch.equal(a, b)] == []


# ------------------------------------------- analysis and the eval CLIs ---- #


def _up_to_sign(got, want):
    sign = torch.sign((got * want).sum(dim=0))
    return got * sign


def test_analysis_functions_on_the_card_match_the_cpu(gen):
    """analysis/latent.py and fid.py on card tensors against the same calls
    on the CPU (fp32): 1e-4, PCA up to each component's sign in both of its
    forms (the Gram matrix for N < D, the covariance else), interpolation
    exact."""
    from medvae_tpu_torch import analysis

    labels = torch.arange(48, device="cuda") % 3
    z = torch.randn(48, 300, generator=gen, device="cuda") + labels[:, None].float()
    for fn in (analysis.pairwise_distances, lambda x: analysis.centroid_distance_matrix(x, labels.to(x.device), 4)[0],
               lambda x: analysis.silhouette_score(x, labels.to(x.device), 4)):
        torch.testing.assert_close(fn(z).cpu(), fn(z.cpu()), rtol=1e-4, atol=1e-4)
    for x in (z, z[:, :12]):  # N < D, then D < N
        card, card_r = analysis.pca(x, 2)
        cpu, cpu_r = analysis.pca(x.cpu(), 2)
        torch.testing.assert_close(card_r.cpu(), cpu_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(_up_to_sign(card.cpu(), cpu), cpu, rtol=1e-4, atol=1e-3)
    real, fake = z[:, :16], z[:, 16:32] * 0.5
    assert abs(analysis.fid_score(real, fake) - analysis.fid_score(real.cpu(), fake.cpu())) <= \
        1e-4 * analysis.fid_score(real.cpu(), fake.cpu())
    a, b = z[0].reshape(10, 10, 3), z[1].reshape(10, 10, 3)
    assert torch.equal(analysis.latent_interpolation(a, b, 5).cpu(),
                       analysis.latent_interpolation(a.cpu(), b.cpu(), 5))


@pytest.fixture
def tiny_run(gen, tmp_path):
    """A tiny quick-flagship checkpoint (seeded weights, fp32) beside its
    composed config.yaml, data of two datasets under tmp_path."""
    import pathlib

    from medvae_tpu_torch.cli.common import save_checkpoint
    from medvae_tpu_torch.config.compose import compose, save_yaml
    from medvae_tpu_torch.config.models import build_model, init_weights

    configs = pathlib.Path(__file__).resolve().parents[1] / "configs"
    cfg = compose(str(configs), "config", [
        "experiment=disentangled_multi_modal_cvae_quick", "data.dataset_names=[chestmnist,pathmnist]",
        "model.hidden_channels=8", "model.ch_mult=[1,2]", "precision=fp32", f"work_dir={tmp_path}"])
    model = init_weights(build_model(cfg["model"], "fp32", "cpu"), seed=0)
    (tmp_path / "run" / "snap").mkdir(parents=True)
    save_checkpoint(str(tmp_path / "run" / "snap" / "checkpoint.pt"), model.state_dict(), cfg["model"], "fp32")
    save_yaml(cfg, tmp_path / "run" / "config.yaml")
    return str(tmp_path / "run" / "snap")


def test_eval_clis_run_on_the_card(tiny_run, tmp_path):
    """generate, evaluate and analyze with their default device (the card):
    their files, finite numbers, and analyze's numbers within 1e-3 of a CPU
    run's (fp32)."""
    import json

    from medvae_tpu_torch.cli import analyze, evaluate, generate

    assert generate.main(["--model_path", tiny_run, "--num_samples", "4", "--interpolate", "3",
                          "--output_dir", str(tmp_path / "gen")]) == 0
    assert (tmp_path / "gen" / "samples_grid.png").exists() and (tmp_path / "gen" / "interpolation_grid.png").exists()
    assert evaluate.main(["--model_path", tiny_run, "--max_batches", "2", "--fid",
                          "--output_dir", str(tmp_path / "eval")]) == 0
    metrics = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    assert all(torch.isfinite(torch.tensor(v.get("mean", v.get("value")))) for v in metrics.values())
    results = {}
    for device in ("cuda", "cpu"):
        assert analyze.main(["--model_path", tiny_run, "--samples_per_modality", "16", "--device", device,
                             "--output_dir", str(tmp_path / device)]) == 0
        results[device] = json.loads((tmp_path / device / "results.json").read_text())
    for k in ("mean_centroid_distance", "silhouette_score", "zmod_centroid_distance", "zmod_silhouette_score"):
        assert abs(results["cuda"][k] - results["cpu"][k]) <= 1e-3 * max(abs(results["cpu"][k]), 1e-2), k


# -------------------------------------- the serving ops and an artifact ---- #

# each op at a shape of its main path: B1 at a ragged n on the wgmma
# instance, B4 at the 128² BaseVAE's, B6 at a flagship level
SERVING_OPS = {"flash_attention": (2, 1000, 512), "attention_fwd": (8, 256, 1024),
               "gn_swish_fwd": (4, 256, 56, 56)}


def _serving_op(gen, name):
    """(op, raw wrapper, plain version, args, launch counts, count key)."""
    shape = SERVING_OPS[name]
    if name == "gn_swish_fwd":
        x, w, b, _, groups = _gn_inputs(gen, shape, torch.bfloat16)
        return (gs.gn_swish_fwd, lambda *a: gs.group_norm_swish_fwd(*a)[0], gs.group_norm_swish_plain,
                (x, w, b, groups, 1e-6), gs.launches, "gn_swish_fwd")
    args = _qkv(gen, shape, torch.bfloat16)
    if name == "flash_attention":
        return (fa.flash_attention, lambda *a: fa.flash_attention_fwd(*a, want_lse=False)[0],
                fa.flash_attention_plain, args, fa.launches, "flash_fwd")
    return at.attention_fwd, at.fused_attention_fwd, at.fused_attention_fwd_plain, args, at.launches, "attention_fwd"


@pytest.mark.parametrize("name", sorted(SERVING_OPS))
def test_serving_op_launches_its_kernel_on_the_card(gen, name):
    """The op's CUDA kernel is the raw wrapper's launch: one launch counted,
    its result that of the raw wrapper bit for bit and the plain version's
    within the bf16 bars."""
    op, raw, plain, args, counts, key = _serving_op(gen, name)
    before = counts[key]
    got = op(*args)
    torch.cuda.synchronize()
    assert counts[key] == before + 1
    assert torch.equal(got, raw(*args))
    want = plain(*args)
    tol_abs, tol_rel = TOLERANCE[torch.bfloat16]
    assert (got.double() - want.double()).abs().max().item() <= tol_abs and _rel(got, want) <= tol_rel
    # any layout in, as a replayed graph may hand it: the same result
    x = args[0].to(memory_format=torch.channels_last) if args[0].dim() == 4 else args[0].mT.contiguous().mT
    assert not x.is_contiguous()
    assert torch.equal(op(x, *args[1:]), got)


def test_serving_ops_raise_on_the_card_instead_of_falling_back(gen):
    q = torch.randn((1, 128, 64), generator=gen, device="cuda")
    before = {**fa.launches, **at.launches, **gs.launches}
    for op in (fa.flash_attention, at.attention_fwd):
        with pytest.raises(TypeError):
            op(q.half(), q.half(), q.half())
        with pytest.raises(ValueError):
            op(q, q.cpu(), q)
    x, w, b, _, _ = _gn_inputs(gen, (2, 64, 8, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="groups"):
        gs.gn_swish_fwd(x, w, b, 24, 1e-6)
    with pytest.raises(ValueError, match="fp32"):
        gs.gn_swish_fwd(x, w.bfloat16(), b, 32, 1e-6)
    assert {**fa.launches, **at.launches, **gs.launches} == before


def test_export_round_trip_on_the_card(gen, tmp_path, monkeypatch):
    """A small flagship (bf16, the card) with MEDVAE_FUSED_GN=1 and the
    attention blocks past B4's envelope sent to B1's op, exported, loaded on
    the card and run: the graph's ops, their launches, and the engine's
    outputs bit for bit (the decoder's conv_in answers a channels-last
    tensor on the card, which the GN op takes)."""
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.nn.blocks import ResnetBlock
    from medvae_tpu_torch.serve import InferenceEngine, export_model, load_exported
    from medvae_tpu_torch.serve.export import medvae_ops

    monkeypatch.setenv("MEDVAE_FUSED_GN", "1")
    monkeypatch.setattr(at, "uses_flash", lambda n, c: True)
    cfg = {"_target_": "DisentangledConditionalVAE", "num_modalities": 5, "shared_latent_dim": 4,
           "modality_latent_dim": 4, "hidden_channels": 64, "ch_mult": [1, 2], "num_res_blocks": 1,
           "attn_resolutions": [16], "resolution": 16}
    weights = init_weights(build_model(cfg, "fp32", "cpu"), seed=0).state_dict()
    model = build_model(cfg, "bf16", "cuda")
    model.load_state_dict(weights)
    meta = export_model(model, str(tmp_path), batch_size=4)
    # two GroupNorm+SiLU sites a res block and each codec's norm_out; the
    # three 16² x 64 attention blocks take B4's envelope, the mid blocks
    # (8² x 128) the flash op
    sites = 2 * sum(isinstance(m, ResnetBlock) for m in model.modules()) + 2
    want_ops = {"medvae.attention_fwd": 3, "medvae.flash_attention": 2, "medvae.gn_swish_fwd": sites}
    assert meta["device"] == "cuda" and meta["fused_gn"] and meta["ops"]["reconstruct"] == want_ops
    art = load_exported(str(tmp_path))
    assert medvae_ops(art["programs"]["reconstruct"]) == want_ops
    x = torch.randint(0, 256, (4, 16, 16, 3), generator=gen, device="cuda", dtype=torch.uint8).cpu().numpy()
    m = torch.arange(4).int().numpy()
    before = (at.launches["attention_fwd"], fa.launches["flash_fwd"], gs.launches["gn_swish_fwd"])
    got = art["reconstruct"](x, m)
    after = (at.launches["attention_fwd"], fa.launches["flash_fwd"], gs.launches["gn_swish_fwd"])
    assert tuple(a - b for a, b in zip(after, before)) == (3, 2, sites)
    want = InferenceEngine(model, buckets=(4,), device="cuda").reconstruct(x, modality=m)
    np.testing.assert_array_equal(got, want)


def test_default_route_on_the_card_is_b6_at_every_site(gen, monkeypatch):
    """With MEDVAE_FUSED_GN unset, a small bf16 flagship's reconstruct on the
    card launches B6 once per GroupNorm+SiLU site: the launch count, the
    trace's B6 kernels and the store's `gn.fused` agree, and the output
    equals MEDVAE_FUSED_GN=1's bit for bit. With 0 every site takes the
    plain route and no B6 runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.core import tracing
    from medvae_tpu_torch.nn.blocks import ResnetBlock
    from medvae_tpu_torch.serve import InferenceEngine

    cfg = {"_target_": "DisentangledConditionalVAE", "num_modalities": 5, "shared_latent_dim": 4,
           "modality_latent_dim": 4, "hidden_channels": 64, "ch_mult": [1, 2], "num_res_blocks": 1,
           "attn_resolutions": [16], "resolution": 16}
    model = build_model(cfg, "bf16", "cuda")
    model.load_state_dict(init_weights(build_model(cfg, "fp32", "cpu"), seed=0).state_dict())
    engine = InferenceEngine(model, buckets=(4,), device="cuda")
    sites = 2 * sum(isinstance(m, ResnetBlock) for m in model.modules()) + 2
    x = torch.randint(0, 256, (4, 16, 16, 3), generator=gen, device="cuda", dtype=torch.uint8).cpu().numpy()
    m = torch.arange(4).int().numpy()
    b6 = ("gn_fwd_", "gn_row_stats", "gn_group_stats", "gn_swish_apply")

    def traced(switch):
        if switch is None:
            monkeypatch.delenv("MEDVAE_FUSED_GN", raising=False)
        else:
            monkeypatch.setenv("MEDVAE_FUSED_GN", switch)
        engine.reconstruct(x, modality=m)  # warm: kernels built, plans made
        torch.cuda.synchronize()
        tracing.reset()
        before = gs.launches["gn_swish_fwd"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = engine.reconstruct(x, modality=m)
            torch.cuda.synchronize()
        kernels = sum(any(f in e.name for f in b6) for e in prof.events() if e.device_type == DeviceType.CUDA)
        counts = {k: v for k, v in tracing.counters().items() if k.startswith("gn.")}
        tracing.reset()
        return out, gs.launches["gn_swish_fwd"] - before, kernels, counts

    try:
        out, launched, kernels, counts = traced(None)
        assert launched == kernels == counts["gn.fused"] == sites and "gn.plain" not in counts
        assert counts["gn.fwd_bytes"] > 0 and "gn.bwd_bytes" not in counts
        assert np.array_equal(out, traced("1")[0])
        out0, launched, kernels, counts = traced("0")
        assert launched == kernels == 0 and counts == {"gn.plain": sites}
        assert not np.array_equal(out0, out)  # the plain route rounds twice: another result
    finally:
        tracing.reset()


# --------------------------- B5's first launch on a thread (ROADMAP §C) ---- #


def _fresh_process(code: str) -> None:
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_b5_through_autograd_after_b6_b7_in_a_fresh_process(gen):
    """B6/B7 through autograd, then B5 through autograd as the process's
    first attention work: autograd's device thread reaches B5 with no
    PyTorch op before it there, so no context was current on that thread
    and cuTensorMapEncodeTiled refused the map (CUresult 201) until the
    launcher bound the device's context itself (hopper.cuh:bind_context)."""
    _fresh_process(
        "import torch\n"
        "from medvae_tpu_torch.ops import attention as at, groupnorm_swish as gs\n"
        "x = torch.randn(4, 64, 28, 28, device='cuda', dtype=torch.bfloat16, requires_grad=True)\n"
        "w = torch.ones(64, device='cuda', requires_grad=True)\n"
        "b = torch.zeros(64, device='cuda', requires_grad=True)\n"
        "torch.autograd.grad(gs.GroupNormSwish.apply(x, w, b, 32, 1e-6).float().sum(), (x, w, b))\n"
        "q, k, v, g = (torch.randn(4, 256, 1024, device='cuda').to(torch.bfloat16) for _ in range(4))\n"
        "leaves = [t.requires_grad_(True) for t in (q, k, v)]\n"
        "torch.autograd.grad(at.FusedAttention.apply(*leaves), leaves, g)\n"
        "torch.cuda.synchronize()\n"
        "assert at.launches == {'attention_fwd': 1, 'attention_bwd': 1}, at.launches\n")


def test_chip_smoke_attention_phase_after_the_flash_phase_in_a_fresh_process(gen):
    """The order that failed (ROADMAP §C): phase_build, phase_kernel (B1
    only), then phase_attn_kernel, whose FusedAttention check runs B5 on
    autograd's device thread first."""
    _fresh_process("import chip_smoke as c; c.phase_build(); c.phase_kernel(); c.phase_attn_kernel()")


def test_b5_launches_from_a_fresh_thread(gen):
    """B5 called directly on a new host thread, whose first CUDA work it is."""
    import threading

    q, k, v, g = _qkv(gen, (4, 256, 1024), torch.bfloat16, 4)
    want = at.fused_attention_bwd(q, k, v, g)
    got = {}

    def work():
        try:
            got["grads"] = at.fused_attention_bwd(q, k, v, g)
        except RuntimeError as e:
            got["error"] = str(e)

    thread = threading.Thread(target=work)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive() and "error" not in got, got.get("error")
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], want))


# ------------------------------------------ fast paths under graph replay ---- #

FAST_MODELS = {
    # B6/B7 at every GroupNorm+SiLU site (MEDVAE_FUSED_GN=1), dropout 0.1
    "gn": dict(_target_="BaseVAE", input_channels=3, latent_dim=4, hidden_channels=32, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(), resolution=28, dropout=0.1),
    # attention at 16² x 64 channels in bf16: B4/B5's Hopper instance, 4 sites
    "attention": dict(_target_="BaseVAE", input_channels=1, latent_dim=4, hidden_channels=64,
                      ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(16,), resolution=32, dropout=0.1),
}


def _fast_run(kind: str, accumulate: int):
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.train import optim, state as tstate, step as tstep

    model = init_weights(build_model(FAST_MODELS[kind], "bf16", "cuda", train=True), seed=1)
    tx = optim.build_optimizer({"type": "adamw", "lr": 1e-3, "weight_decay": 1e-4},
                               {"type": "cosine", "T_max": 2}, steps_per_epoch=3)
    state = tstate.create_train_state(model, tx, {}, ema_decay=0.99)
    step = tstep.build_train_step(model, {"type": "vae", "kl_weight": 1e-3}, tx, augment=True,
                                  max_channels=FAST_MODELS[kind]["input_channels"], ema_decay=0.99,
                                  accumulate_grad_batches=accumulate)
    return state, step


def _all_launches():
    return {**at.launches, **fa.launches, **gs.launches}


def _reset_all():
    for mod in (at, fa, gs):
        mod.reset_launches()


@pytest.mark.parametrize("kind, accumulate", [("gn", 1), ("gn", 2), ("attention", 1)])
def test_fused_chunk_equals_per_step_calls_bit_for_bit(gen, monkeypatch, kind, accumulate):
    """Seven steps as chunks (1, 4, 2) of replays of one captured step, and
    as per-step calls: params, EMA, moments and the last metrics bit for
    bit, and the kernels' counts under replay the per-step calls' counts."""
    from medvae_tpu_torch.data.medmnist import SplitArrays
    from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder
    from medvae_tpu_torch.train.multistep import build_chunk_runner

    monkeypatch.setenv("MEDVAE_FUSED_GN", "1" if kind == "gn" else "0")
    cfg = FAST_MODELS[kind]
    size, ch = cfg["resolution"], cfg["input_channels"]
    rs = np.random.RandomState(0)
    split = SplitArrays(images=rs.randint(0, 256, (96, size, size, ch)).astype(np.uint8),
                        labels=np.zeros(96, np.int32), modality_idx=rs.randint(0, 5, 96).astype(np.int32),
                        channels=ch)
    feeder = DeviceCachedFeeder(split, 8, "cuda", seed=3)
    seed_of = lambda s: 77 + s  # noqa: E731
    state, step = _fast_run(kind, accumulate)
    loop_gen, perm = torch.Generator(device="cuda"), feeder.epoch_perm(2)
    _reset_all()
    for i in range(7):
        loop_gen.manual_seed(seed_of(state.step))
        state, loop_metrics = step(state, feeder.assemble(perm, torch.tensor(i, device="cuda")), loop_gen)
    torch.cuda.synchronize()
    loop_launches = _all_launches()
    want = {**{k: v.clone() for k, v in state.params.items()},
            **{f"ema.{k}": v.clone() for k, v in state.ema_params.items()},
            **{f"nu{i}": v.clone() for i, v in enumerate(state.opt_state.nu)}}

    state, step = _fast_run(kind, accumulate)
    run = build_chunk_runner(step, feeder, torch.Generator(device="cuda"), seed_of)
    _reset_all()
    for step0, n in ((0, 1), (1, 4), (5, 2)):
        state, metrics = run(state, 2, step0, n)
    torch.cuda.synchronize()
    got = {**state.params, **{f"ema.{k}": v for k, v in state.ema_params.items()},
           **{f"nu{i}": v for i, v in enumerate(state.opt_state.nu)}}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in loop_metrics:
        assert torch.equal(metrics[k], loop_metrics[k]), k
    assert _all_launches() == loop_launches
    kernels = ("gn_swish_fwd", "gn_swish_bwd") if kind == "gn" else ("attention_fwd", "attention_bwd")
    assert all(loop_launches[k] > 0 for k in kernels), loop_launches


def _state_tensors(state):
    """Every tensor a step updates, by name: params, EMA, both optimizers'
    moments, the discriminator's params and batch statistics."""
    out = dict(state.params)
    for prefix, tensors in (("ema.", state.ema_params), ("disc.", state.disc_params),
                            ("disc_stats.", state.disc_batch_stats)):
        out.update({prefix + k: v for k, v in (tensors or {}).items()})
    for prefix, opt in (("opt.", state.opt_state), ("disc_opt.", state.disc_opt_state)):
        if opt is not None:
            out.update({f"{prefix}mu{i}": v for i, v in enumerate(opt.mu)})
            out.update({f"{prefix}nu{i}": v for i, v in enumerate(opt.nu)})
    return out


# the GAN step (a concat ConditionalVAE, the fp32 PatchGAN and LPIPS tower,
# the discriminator's gate opening at step 3, inside the second chunk) and
# the disentangled flagship's step with its fp32 towers (LPIPS and the
# BiomedCLIP ViT), its attention at 16² x 64 through B4/B5 and at the 8² x
# 128 mid blocks through flash attention (B1-B3)
LOSS_CASES = {
    "gan": ({"_target_": "ConditionalVAE", "input_channels": 3, "latent_dim": 8, "hidden_channels": 32,
             "ch_mult": [1, 2, 4], "num_res_blocks": 1, "attn_resolutions": [], "resolution": 28,
             "dropout": 0.1},
            {"type": "lpips_discriminator", "pixel_factor": 1.0, "discriminator_iter_start": 3}),
    "disentangled": ({"_target_": "DisentangledConditionalVAE", "num_modalities": 5, "shared_latent_dim": 4,
                      "modality_latent_dim": 4, "hidden_channels": 64, "ch_mult": [1, 2],
                      "num_res_blocks": 1, "attn_resolutions": [16], "resolution": 16, "dropout": 0.1},
                     {"type": "disentangled_vae", "recon_loss_type": "mse", "kl_weight": 1.0,
                      "separation_weight": 0.1, "contrastive_weight": 0.2, "perceptual_weight": 0.1,
                      "biomedclip_weight": 0.1, "clip_encoder": "vit"}),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_fused_chunk_of_the_loss_steps_equals_per_step_calls_bit_for_bit(gen, monkeypatch, case):
    """The GAN step and the disentangled flagship's step, with their fp32
    loss towers, as chunks (1, 4, 2) of replays of one captured step and as
    seven per-step calls: every tensor the step updates and the last
    metrics bit for bit, and the kernels' counts under replay the per-step
    calls' counts, each kernel of the path launched. A host value baked
    into the capture (a Python number of the losses, the GAN's gate) would
    show as a difference."""
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.data.medmnist import SplitArrays
    from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder
    from medvae_tpu_torch.nn.discriminator import build_discriminator
    from medvae_tpu_torch.train import optim, state as tstate, step as tstep
    from medvae_tpu_torch.train.multistep import build_chunk_runner

    monkeypatch.setenv("MEDVAE_FUSED_GN", "1")
    monkeypatch.setattr(at, "uses_flash", lambda n, c: True)
    cfg, loss = LOSS_CASES[case]
    size = cfg["resolution"]
    rs = np.random.RandomState(0)
    split = SplitArrays(images=rs.randint(0, 256, (64, size, size, 3)).astype(np.uint8),
                        labels=np.zeros(64, np.int32), modality_idx=rs.randint(0, 5, 64).astype(np.int32),
                        channels=3)
    feeder = DeviceCachedFeeder(split, 4, "cuda", seed=3)
    weights = init_weights(build_model(cfg, "fp32", "cpu", train=True), seed=0).state_dict()
    frozen = tstep.make_frozen(loss, "cuda", seed=0)
    seed_of = lambda s: 91 + s  # noqa: E731

    def fresh():
        model = build_model(cfg, "bf16", "cuda", train=True)
        model.load_state_dict(weights)
        opt = {"type": "adamw", "lr": 1e-4, "weight_decay": 1e-4}
        tx = optim.build_optimizer(opt, {"type": "cosine", "T_max": 2}, steps_per_epoch=3)
        gan = {}
        if case == "gan":
            gan = {"disc": build_discriminator(None, "cuda", seed=7), "disc_tx": optim.discriminator_optimizer(opt)}
        state = tstate.create_train_state(model, tx, frozen, ema_decay=0.99, **gan)
        step = tstep.build_train_step(model, loss, tx, augment=True, max_channels=3, ema_decay=0.99, **gan)
        return state, step

    state, step = fresh()
    loop_gen, perm = torch.Generator(device="cuda"), feeder.epoch_perm(1)
    _reset_all()
    for i in range(7):
        loop_gen.manual_seed(seed_of(state.step))
        state, loop_metrics = step(state, feeder.assemble(perm, torch.tensor(i, device="cuda")), loop_gen)
    torch.cuda.synchronize()
    loop_launches = _all_launches()
    want = {k: v.clone() for k, v in _state_tensors(state).items()}

    state, step = fresh()
    run = build_chunk_runner(step, feeder, torch.Generator(device="cuda"), seed_of)
    _reset_all()
    for step0, n in ((0, 1), (1, 4), (5, 2)):
        state, metrics = run(state, 1, step0, n)
    torch.cuda.synchronize()
    got = _state_tensors(state)
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    assert [k for k in loop_metrics if not torch.equal(metrics[k], loop_metrics[k])] == []
    assert _all_launches() == loop_launches
    kernels = ("gn_swish_fwd", "gn_swish_bwd") + (
        ("flash_fwd", "flash_bwd", "attention_fwd", "attention_bwd") if case == "disentangled" else ())
    assert all(loop_launches[k] > 0 for k in kernels), loop_launches
    if case == "gan":  # the gate opened inside the chunks: the adversarial terms moved
        assert float(metrics["train/d_weight"]) > 0 and float(metrics["train/d_loss"]) > 0


# ------------------------- the 1024² KL-f8 autoencoder's largest sites ---- #


def test_gn_swish_past_2_31_elements_launches_in_slices(gen):
    """The 1024² decoder's first block at bs 8 (8, 256, 1024, 1024), 2^31
    elements: B6 and B7 launch once a batch slice (two of four images),
    each slice's outputs equal B6/B7 run on that slice alone bit for bit,
    dγ and dβ are the slices' summed in order, and the whole is within the
    bars of `test_gn_swish_kernels_match_plain_versions` of the plain fp32
    version (computed a slice at a time: a group's statistics are one
    image's), but for y's elementwise floor: 2e-6 where those bars have
    1e-6. A group here is 8.4 M elements, and the streamed instance's fp32
    statistics over a launch of four images are 1.2e-6 off in the mean
    (against 2e-8 at one image, and 4e-8 for the plain version's; H100,
    against fp64), which moves outputs near zero by up to 1.2e-6: 420 of
    the slice's 2^30 outputs, all under 5e-6 in magnitude."""
    shape, dtype = (8, 256, 1024, 1024), torch.bfloat16
    slices = gs.batch_slices(shape, 2)
    assert slices == [(0, 4), (4, 8)]
    x, w, b, g, groups = _gn_inputs(gen, shape, dtype)
    before = dict(gs.launches)
    y, mean, rstd = gs.group_norm_swish_fwd(x, w, b, groups, 1e-6)
    dx, dw, db = gs.group_norm_swish_bwd(x, w, b, g, mean, rstd)
    torch.cuda.synchronize()
    assert gs.launches == {k: v + len(slices) for k, v in before.items()}
    dw_sum = db_sum = dw_ref = db_ref = None
    for lo, hi in slices:
        ys, ms, rs = gs.group_norm_swish_fwd(x[lo:hi], w, b, groups, 1e-6)
        dxs, dws, dbs = gs.group_norm_swish_bwd(x[lo:hi], w, b, g[lo:hi], ms, rs)
        assert torch.equal(y[lo:hi], ys) and torch.equal(mean[lo:hi], ms) and torch.equal(rstd[lo:hi], rs)
        assert torch.equal(dx[lo:hi], dxs)
        dw_sum, db_sum = (dws, dbs) if dw_sum is None else (dw_sum + dws, db_sum + dbs)
        del ys, dxs
        y_ref, mean_ref, rstd_ref = gs.group_norm_swish_fwd_plain(x[lo:hi], w, b, groups, 1e-6)
        got, want = y[lo:hi].double(), y_ref.double()
        assert torch.isfinite(got).all() and _rel(got, want) <= 2e-3
        assert bool(((got - want).abs() <= 2.0**-7 * want.abs() + 2e-6).all())
        del got, want
        assert _rel(mean[lo:hi], mean_ref) <= 1e-5 and _rel(rstd[lo:hi], rstd_ref) <= 1e-5
        del y_ref
        dx_ref, dws_ref, dbs_ref = gs.group_norm_swish_bwd_plain(x[lo:hi], w, b, g[lo:hi], ms, rs)
        _assert_grad_close(dx[lo:hi], dx_ref, dtype, f"dx[{lo}:{hi}]")
        del dx_ref
        dw_ref, db_ref = (dws_ref, dbs_ref) if dw_ref is None else (dw_ref + dws_ref, db_ref + dbs_ref)
    assert torch.equal(dw, dw_sum) and torch.equal(db, db_sum)
    assert _rel(dw, dw_ref) <= 1e-3 and _rel(db, db_ref) <= 1e-3
    again = gs.group_norm_swish_bwd(x, w, b, g, mean, rstd)
    assert all(torch.equal(a, b_) for a, b_ in zip((dx, dw, db), again))


def test_flash_at_16384_tokens_matches_per_image_fp32_attention(gen):
    """The 1024² autoencoder's mid-block attention at bs 8: (8, 16384, 512)
    bf16 routes to B1 (one launch) and agrees, image by image, with a plain
    attention of the same operands in fp32 under B1's bf16 bars."""
    shape = (8, 16384, 512)
    assert at.uses_flash(16384, 512) and not at.uses_fused(16384, 512)
    q, k, v = _qkv(gen, shape, torch.bfloat16)
    before = fa.launches["flash_fwd"]
    with torch.no_grad():
        got = at.attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 1 and got.dtype == torch.bfloat16
    tol_abs, tol_rel = TOLERANCE[torch.bfloat16]
    for i in range(shape[0]):
        logits = torch.matmul(q[i].float(), k[i].float().T) * shape[2] ** -0.5
        want = torch.matmul(torch.softmax(logits, dim=-1), v[i].float())
        del logits
        err = (got[i].double() - want.double()).abs().max().item()
        assert torch.isfinite(got[i]).all() and err <= tol_abs and _rel(got[i], want) <= tol_rel, (i, err)


# ------------------------------------------- the fused AdamW route (ops/adamw.py) ---- #

# the 224² GAN's generator (portbench/configs/gan224.json): 250 params, 906.3 M
GAN_G = {"_target_": "ConditionalVAE", "input_channels": 3, "latent_dim": 256, "hidden_channels": 256,
         "ch_mult": [1, 2, 4, 8], "num_res_blocks": 2, "attn_resolutions": [16], "dropout": 0.0,
         "resolution": 224, "condition_method": "concat", "double_z": True,
         "modalities": ["m%d" % i for i in range(12)]}
# odd lengths, single elements, chunk edges and more tensors than a launch takes
ADAMW_SMALL = [(1,), (3,), (5, 7), (4099,), (65536,), (65537,), (2, 3, 3, 3), (131075,)] + [(33,)] * 70


def _adamw_shapes(which):
    if which == "small":
        return ADAMW_SMALL
    from medvae_tpu_torch.config.models import build_model

    model = build_model(GAN_G, "bf16", "meta", train=True)
    return [tuple(p.shape) for p in model.parameters() if p.requires_grad]


def _adamw_case(gen, shapes, kind, clip, engaged=True, lr=1e-4, unaligned=False):
    """(tx, params, state, grads, lr_scale): moments and params random, the
    state prepared for its sixth update; grads scaled so that the clip is
    engaged or not. `unaligned` puts every tensor 4 bytes past an
    allocation."""
    from medvae_tpu_torch.train import optim

    tx = optim.build_optimizer({"type": kind, "lr": lr, "weight_decay": 1e-5, "betas": (0.5, 0.999)},
                               {"type": "cosine", "T_max": 150, "eta_min": 1e-7}, steps_per_epoch=85,
                               gradient_clip_val=clip)

    def make(shape, scale, positive=False):
        n = int(np.prod(shape))
        t = torch.randn(n + int(unaligned), generator=gen, device="cuda")
        t = (t.abs() if positive else t) * scale
        return t[int(unaligned):].view(shape)

    params = [make(s, 0.05) for s in shapes]
    state = tx.init(params)
    state.mu = [make(s, 0.01) for s in shapes]
    state.nu = [make(s, 1e-4, positive=True) for s in shapes]
    state.count = 5
    tx.prepare(state)
    numel = sum(int(np.prod(s)) for s in shapes)
    scale = 1.0 if engaged else 0.5 / float(np.sqrt(numel))
    grads = [make(s, scale) for s in shapes]
    return tx, params, state, grads, torch.tensor(0.75, device="cuda")


def _plain_adamw(tx, params, state, grads, lr_scale):
    """The plain chain on clones: (params, mu, nu, its norm)."""
    from medvae_tpu_torch.train import optim

    ps, st = [p.clone() for p in params], dataclasses.replace(state, mu=[m.clone() for m in state.mu],
                                                              nu=[v.clone() for v in state.nu])
    optim.add_updates(ps, tx.apply(grads, st, ps), lr_scale)
    norm = optim.global_norm([torch.where(torch.isnan(g), 0.0, g) for g in grads])
    return ps, st.mu, st.nu, norm


def _fused_adamw(tx, params, state, grads, lr_scale, norm=None):
    """The kernels on clones, clipped by `norm` (the kernels' own by
    default): (params, mu, nu, the norm used)."""
    from medvae_tpu_torch.ops import adamw

    ps, mu, nu = [p.clone() for p in params], [m.clone() for m in state.mu], [v.clone() for v in state.nu]
    ws = adamw.Workspace.of(ps)
    if tx.clip and norm is None:
        norm = adamw.global_norm_(grads, ws).clone()
    adamw.update_(grads, mu, nu, ps, ws, tx.hyper(state, lr_scale), norm if tx.clip else None)
    return ps, mu, nu, norm


def _same_bits(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{what}[{i}]: {m}")


@pytest.mark.parametrize("case, want", [
    ("adam", True), ("adamw", True), ("strided grad", True), ("sgd", False), ("swapped norm", False),
    ("strided param", False), ("bf16 grad", False), ("grad of another shape", False), ("a grad missing", False),
    ("a grad on the cpu", False),
])
def test_adamw_route_gate(gen, case, want):
    """Adam and AdamW with the plain norm over fp32 card tensors of one shape
    take the kernels, a strided gradient too (copied); SGD, tensor
    parallelism's norm, a strided param, a bf16 gradient, a shape that
    differs, a missing gradient or one on another device take the plain
    chain."""
    from medvae_tpu_torch.ops import adamw
    from medvae_tpu_torch.train import optim

    kind = case if case in ("adam", "sgd") else "adamw"
    tx, params, state, grads, _ = _adamw_case(gen, ADAMW_SMALL[:4], kind, 1.0)
    nu = state.nu or [torch.zeros_like(p) for p in params]
    if case == "swapped norm":
        tx = dataclasses.replace(tx, norm=lambda ts: optim.global_norm(ts) * 1.0)
    if case == "strided grad":
        grads[2] = torch.randn(7, 5, generator=gen, device="cuda").t()
    if case == "strided param":
        params[2] = torch.randn(7, 5, generator=gen, device="cuda").t()
    if case == "bf16 grad":
        grads[1] = grads[1].bfloat16()
    if case == "grad of another shape":
        grads[2] = grads[2].reshape(7, 5)
    if case == "a grad missing":
        grads = grads[:-1]
    if case == "a grad on the cpu":
        grads[0] = grads[0].cpu()
    assert adamw.fused_route(tx.kind, tx.norm is optim.global_norm, grads, state.mu, nu, params) is want


@pytest.mark.parametrize("which", ["gan_g", "small"])
@pytest.mark.parametrize("kind, clip, engaged",[("adamw", 1.0, True), ("adamw", 1.0, False), ("adam", 1.0, True),
                                                 ("adam", None, True)])
def test_adamw_update_equals_the_plain_chain_bit_for_bit(gen, which, kind, clip, engaged):
    """Given the plain chain's norm, the update kernels leave m, v and p bit
    for bit where optim.Optimizer.apply and the step's add leave them, at
    the GAN generator's 250 shapes and at odd, single-element and
    chunk-edge sizes over two launches; the kernels' own norm is within
    2e-6 of the plain `global_norm`."""
    tx, params, state, grads, lr_scale = _adamw_case(gen, _adamw_shapes(which), kind, clip, engaged)
    want_p, want_m, want_v, norm = _plain_adamw(tx, params, state, grads, lr_scale)
    got_p, got_m, got_v, _ = _fused_adamw(tx, params, state, grads, lr_scale, norm)
    torch.cuda.synchronize()
    _same_bits(got_m, want_m, "m")
    _same_bits(got_v, want_v, "v")
    _same_bits(got_p, want_p, "p")
    assert any(not torch.equal(a, b) for a, b in zip(got_p, params))
    if clip:
        from medvae_tpu_torch.ops import adamw

        own = adamw.global_norm_(grads, adamw.Workspace.of(params)).item()
        assert abs(own - norm.item()) <= 2e-6 * norm.item(), (own, norm.item())
        assert (norm.item() >= clip) is engaged


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adamw_strided_grads_as_the_plain_chain(gen, kind):
    """Channels-last conv weight gradients (as the flagship's encoders give)
    take the route through `Optimizer.apply_`, copied to contiguous memory:
    with the clip not engaged, where the norm's rounding cannot show, m, v
    and p equal the plain chain's bit for bit."""
    from medvae_tpu_torch.core import tracing
    from medvae_tpu_torch.ops import adamw

    shapes = [(32, 3, 3, 3), (64, 32, 3, 3), (7,), (256, 128, 3, 3)]
    tx, params, state, grads, lr_scale = _adamw_case(gen, shapes, kind, 1.0, engaged=False)
    grads = [g.contiguous(memory_format=torch.channels_last) if g.dim() == 4 else g for g in grads]
    assert not grads[1].is_contiguous()
    want_p, want_m, want_v, norm = _plain_adamw(tx, params, state, grads, lr_scale)
    assert norm.item() < 1.0
    adamw.reset_launches()
    tracing.enable(True)
    try:
        tx.apply_(grads, state, params, lr_scale)
        counted = tracing.counters()
    finally:
        tracing.enable(None)
        tracing.reset()
    torch.cuda.synchronize()
    assert counted["optim.fused"] == 1 and adamw.launches["adamw_update"] == 1
    _same_bits(state.mu, want_m, "m")
    _same_bits(state.nu, want_v, "v")
    _same_bits(params, want_p, "p")


@pytest.mark.parametrize("case", ["nan", "+inf", "-inf"])
def test_adamw_nan_and_inf_as_the_plain_chain(gen, case):
    """A NaN gradient element counts as 0 in the norm and the update; ±inf
    stays (the norm is inf, the clip sends finite elements to 0 and the
    infinite ones to NaN), as in the plain chain; the misaligned tensors
    take the element path."""
    from medvae_tpu_torch.ops import adamw

    tx, params, state, grads, lr_scale = _adamw_case(gen, ADAMW_SMALL, "adamw", 1.0, unaligned=True)
    value = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}[case]
    grads[2].view(-1)[7] = value
    grads[5].view(-1)[-1] = value
    want_p, want_m, want_v, norm = _plain_adamw(tx, params, state, grads, lr_scale)
    own = adamw.global_norm_(grads, adamw.Workspace.of(params)).item()
    if case == "nan":
        assert abs(own - norm.item()) <= 2e-6 * norm.item()
    else:
        assert own == norm.item() == float("inf")
    got_p, got_m, got_v, _ = _fused_adamw(tx, params, state, grads, lr_scale, norm)
    _same_bits(got_m, want_m, "m")
    _same_bits(got_v, want_v, "v")
    _same_bits(got_p, want_p, "p")


def test_adamw_runs_twice_to_the_same_bits(gen):
    """The norm (no atomics) and the update, twice, at the generator's shapes."""
    tx, params, state, grads, lr_scale = _adamw_case(gen, _adamw_shapes("gan_g"), "adamw", 1.0)
    first, second = (_fused_adamw(tx, params, state, grads, lr_scale) for _ in range(2))
    assert torch.equal(first[3], second[3])
    for a, b in zip(first[:3], second[:3]):
        _same_bits(a, b, "second run")


def test_adamw_route_through_apply_and_a_captured_two_optimizer_update(gen):
    """`Optimizer.apply_` takes the kernels on the card (`optim.fused`), and a
    CUDA-graph capture of two optimizers' updates (the GAN step's G and D),
    replayed, leaves params and moments bit for bit where eager calls leave
    them, with the kernels' launches counted under replay as eager."""
    from medvae_tpu_torch.core import tracing
    from medvae_tpu_torch.ops import adamw
    from medvae_tpu_torch.train import optim
    from medvae_tpu_torch.train.multistep import _Captured

    def two(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        cases = [_adamw_case(g, ADAMW_SMALL, "adamw", 1.0), _adamw_case(g, ADAMW_SMALL[:9], "adamw", 1.0, lr=5e-5)]
        return [(tx, [p.clone() for p in ps], st, gs) for tx, ps, st, gs, _ in cases]

    lr_scale = torch.tensor(0.75, device="cuda")

    def steps(opts, n, capture):
        captured = None
        for i in range(n):
            for tx, _, st, _ in opts:
                st.count = 5 + i
                tx.prepare(st)
            if captured is not None:
                captured.replay()
                continue
            run = lambda: [tx.apply_(gs, st, ps, lr_scale) for tx, ps, st, gs in opts]  # noqa: E731
            run()
            if capture:
                torch.cuda.synchronize()
                captured = _Captured(run, [])
        torch.cuda.synchronize()
        return [t.clone() for _, ps, st, _ in opts for t in ps + st.mu + st.nu]

    adamw.reset_launches()
    tracing.enable(True)
    try:
        want = steps(two(3), 4, capture=False)
        counted = tracing.counters()
    finally:
        tracing.enable(None)
        tracing.reset()
    assert counted["optim.fused"] == 8 and "optim.plain" not in counted
    assert counted["optim.least_bytes"] == 4 * 32 * sum(int(np.prod(s)) for s in ADAMW_SMALL + ADAMW_SMALL[:9])
    eager = dict(adamw.launches)
    assert eager == {"adamw_sumsq": 4 * 3, "adamw_norm": 4 * 2, "adamw_update": 4 * 3}
    adamw.reset_launches()
    got = steps(two(3), 4, capture=True)
    assert adamw.launches == eager
    _same_bits(got, want, "captured")
    ref = steps([(dataclasses.replace(tx, norm=lambda ts: optim.global_norm(ts)), ps, st, gs)
                 for tx, ps, st, gs in two(3)], 4, capture=False)
    for a, b in zip(got, ref):  # the plain chain (a swapped norm), to the norm's rounding
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-9)
