"""The port's fused GroupNorm + SiLU (kernels B6 and B7) on the CPU.

On the CPU the wrappers take their plain PyTorch versions, so these hold the
plain versions, the functions the CUDA kernels are held to on the card,
against the JAX package's Pallas kernels run as tests/test_ops.py runs them:
in Pallas interpret mode with the backend gate opened and MEDVAE_FUSED_GN=1.
The JAX kernels take NHWC and the port NCHW; inputs come from numpy seeds.
Tolerances: forward 1e-5 and backward 2e-4, the JAX package's own bars
(tests/test_ops.py:73,107); the switch on against off in a ResnetBlock, fp32,
1e-5 on the output and the input gradient and 1e-5 relative L2 on each
parameter gradient. The kernels' plan (`gn_swish_plan`) is held here too:
every GN+SiLU shape of the three main-path models, found by forwards on the
meta device, takes an instance that reads each group once, within the
card's shared memory, and the plan's limits are the CUDA source's.
"""

import ctypes
import dataclasses
import importlib
import math
import re
import sys
import types
from pathlib import Path

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


# ------------------------------------------------------- the kernels' plan ---- #

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "medvae_tpu_torch/ops/csrc/groupnorm_swish.cu"


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        yield importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))


@pytest.fixture(scope="module")
def main_path_shapes(chip_smoke):
    """(shape, groups) -> sites a step of the bs-4096 CVAE, the bs-32 flagship
    and the bs-64 128² BaseVAE, from forwards on the meta device."""
    return chip_smoke.main_path_gn_shapes(with_base128=True)


def test_main_paths_have_the_sites_the_launch_counts_expect(main_path_shapes):
    assert {path: sum(sites.values()) for path, sites in main_path_shapes.items()} == {
        "cvae28_train": 28, "flagship_fused_gn": 50, "base128_train": 50}
    assert len(main_path_shapes["cvae28_train"]) == 7


@pytest.mark.parametrize("path", ["cvae28_train", "flagship_fused_gn", "base128_train"])
@pytest.mark.parametrize("backward", [False, True])
def test_every_main_path_bf16_shape_is_planned_resident_or_cluster(main_path_shapes, path, backward):
    for shape, groups in main_path_shapes[path]:
        plan = gs.gn_swish_plan(shape, 2, groups, sms=132, backward=backward)
        cg = shape[1] // groups
        length = cg * shape[2] * shape[3]
        nbuf = 2 if backward else 1
        assert plan.instance in ("resident", "cluster"), (shape, plan)
        assert 0 < plan.smem_bytes <= gs.SMEM_MAX, (shape, plan)
        if plan.instance == "resident":
            assert (plan.groups_per_span * length * 2) % 16 == 0, (shape, plan)
            assert plan.smem_bytes == 3072 + plan.stages * plan.groups_per_span * length * 2 * nbuf
            assert plan.stages >= 2
            assert plan.lanes == (8 if length <= 256 else 16 if length <= 1024 else 32 if length <= 2048 else 256)
            assert plan.groups_per_span % (256 // plan.lanes if plan.lanes <= 32 else 1) == 0
        else:
            assert 2 <= plan.cluster <= 8 and cg <= 32, (shape, plan)
            sl = (-(-length // plan.cluster) + 7) // 8 * 8
            assert plan.smem_bytes == 3072 + sl * 2 * nbuf and (sl * 2) % 16 == 0


# the full-width GAN experiment's bs-24 step (configs/experiment/multi_modal_cvae.yaml):
# (b, c, h, w) -> (sites a step, B6's instance, B7's instance)
GAN224_PLANS = {
    (24, 256, 224, 224): (10, "cluster", "cluster"),
    (24, 512, 224, 224): (1, "cluster", "streamed"),  # a 1.6 MB group: x and g fit no cluster of 8
    (24, 256, 112, 112): (1, "cluster", "cluster"),
    (24, 512, 112, 112): (8, "cluster", "cluster"),
    (24, 1024, 112, 112): (1, "cluster", "cluster"),
    (24, 512, 56, 56): (1, "cluster", "cluster"),
    (24, 1024, 56, 56): (8, "cluster", "cluster"),
    (24, 2048, 56, 56): (1, "streamed", "streamed"),  # 64 channels a group
    (24, 1024, 28, 28): (1, "resident", "cluster"),
    (24, 2048, 28, 28): (18, "streamed", "streamed"),
}


def test_gan224_shapes_are_planned_and_within_the_kernels_element_limit(chip_smoke):
    """Every GroupNorm+SiLU (shape, groups) of the full-width GAN model at
    bs 24, from a meta-device forward: its sites, B6's and B7's instance on
    a 132-SM card, a plan whose shared memory fits, and fewer than 2^31
    elements (ops/groupnorm_swish.py:_check; the largest is 617 M)."""
    sites = chip_smoke.main_path_gn_shapes(with_gan224=True)["gan224_train"]
    assert {shape: n for (shape, _), n in sites.items()} == {k: v[0] for k, v in GAN224_PLANS.items()}
    assert sum(sites.values()) == 50
    for (shape, groups), _ in sites.items():
        assert groups == 32
        _, fwd, bwd = GAN224_PLANS[shape]
        for backward, want in ((False, fwd), (True, bwd)):
            plan = gs.gn_swish_plan(shape, 2, groups, sms=132, backward=backward)
            assert plan.instance == want == gs.gn_swish_instance(shape, torch.bfloat16, backward), (shape, plan)
            assert plan.smem_bytes <= gs.SMEM_MAX
        assert math.prod(shape) < 2**31
    assert max(math.prod(shape) for shape in GAN224_PLANS) == 616_562_688


@pytest.mark.parametrize("shape, dtype, want", [
    ((4096, 32, 28, 28), torch.bfloat16, ("resident", "resident")),
    ((4096, 128, 7, 7), torch.bfloat16, ("resident", "resident")),
    ((32, 128, 224, 224), torch.bfloat16, ("cluster", "cluster")),
    ((1, 128, 224, 224), torch.bfloat16, ("cluster", "cluster")),
    ((32, 256, 56, 56), torch.bfloat16, ("resident", "cluster")),
    ((2, 1024, 28, 28), torch.float32, ("cluster", "cluster")),
    ((32, 128, 448, 448), torch.float32, ("streamed", "streamed")),
    ((2, 2048, 64, 64), torch.bfloat16, ("streamed", "streamed")),
])
def test_instance_names(shape, dtype, want):
    """The instance by shape: resident while a span of whole groups holds at
    most 64 KB, a cluster of up to 8 blocks while a slice fits one block and
    the group has at most 32 channels, streamed past that."""
    assert (gs.gn_swish_instance(shape, dtype), gs.gn_swish_instance(shape, dtype, backward=True)) == want


def test_plan_overrides_and_refusals():
    """The default plans, a forced instance, `plan_smem` recounting a plan
    changed with dataclasses.replace, spans cut to what two stages of a
    block hold, and the forced instances the kernels cannot take."""
    plan = gs.gn_swish_plan((4096, 32, 28, 28), 2, 32, sms=132)
    assert (plan.groups_per_span, plan.stages, plan.lanes) == (16, 2, 16)
    assert gs.gn_swish_plan((4096, 128, 7, 7), 2, 32, sms=132).lanes == 8
    three = dataclasses.replace(plan, stages=3)
    assert gs.plan_smem(three, 784, 2, False) == 3072 + 3 * 16 * 784 * 2
    assert gs.plan_smem(plan, 784, 2, False) == plan.smem_bytes
    wide = gs.gn_swish_plan((2, 128, 224, 224), 2, 32, 132, instance="cluster")
    assert gs.plan_smem(dataclasses.replace(wide, cluster=16), 4 * 224 * 224, 2, False) == 3072 + 12544 * 2
    # fp32 B7 at L = 1024: 16 segments' groups would need 2 x 128 KB; 14 fit
    fp32 = gs.gn_swish_plan((2, 32, 32, 32), 4, 32, 132, backward=True)
    assert (fp32.instance, fp32.groups_per_span, fp32.smem_bytes) == ("resident", 14, gs.SMEM_MAX)
    streamed = gs.gn_swish_plan((4096, 32, 28, 28), 2, 32, 132, instance="streamed")
    assert streamed.splits == gs.splits_for(4096 * 32, 784, 132) and streamed.smem_bytes == 0
    with pytest.raises(ValueError, match="resident"):
        gs.gn_swish_plan((32, 128, 224, 224), 2, 32, 132, instance="resident")
    with pytest.raises(ValueError, match="cluster"):  # 64 channels a group
        gs.gn_swish_plan((2, 2048, 64, 64), 2, 32, 132, instance="cluster")
    with pytest.raises(ValueError, match="unknown"):
        gs.gn_swish_plan((4, 32, 8, 8), 2, 32, 132, instance="tiled")


def test_plan_for_plans_each_shape_once(monkeypatch):
    """The wrappers plan at every call; `plan_for` asks the card and plans a
    shape once, and a new shape, dtype or direction gets its own plan."""
    asked = []

    def props(device):
        asked.append(device)
        return types.SimpleNamespace(multi_processor_count=132)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    gs._plan_on.cache_clear()
    x = torch.empty((4096, 32, 28, 28), dtype=torch.bfloat16, device="meta")
    meta_on = lambda t: types.SimpleNamespace(shape=t.shape, element_size=t.element_size,
                                              device=types.SimpleNamespace(index=0))
    first = gs.plan_for(meta_on(x), 32)
    assert gs.plan_for(meta_on(x), 32) is first and len(asked) == 1
    assert first == gs.gn_swish_plan(x.shape, 2, 32, 132)
    assert gs.plan_for(meta_on(x), 32, backward=True) == gs.gn_swish_plan(x.shape, 2, 32, 132, True)
    assert gs.plan_for(meta_on(x), 32, instance="streamed").instance == "streamed"
    assert len(asked) == 3
    gs._plan_on.cache_clear()


def _cu_constant(name: str) -> int:
    found = re.search(rf"constexpr (?:int|long long) {name} = (\d+)", CSRC.read_text())
    assert found, name
    return int(found[1])


def test_plan_limits_are_the_kernels():
    """The Python plan and the CUDA source count shared memory alike (the
    kernels also refuse a plan whose count differs from theirs)."""
    assert _cu_constant("kMaxSmem") == gs.SMEM_MAX
    assert _cu_constant("kHeader") == gs._HEADER
    assert _cu_constant("kMaxCluster") == gs._MAX_CLUSTER
    assert _cu_constant("kMaxCg") == gs._MAX_CG
    assert _cu_constant("kMaxStages") == gs._MAX_STAGES
    assert _cu_constant("kThreads") == gs._THREADS
    fields = re.search(r"struct Plan \{\s*int ([\w, ]+);", CSRC.read_text())[1].split(", ")
    assert fields == ["instance", "span", "stages", "cluster", "splits", "lanes", "smem"]
    assert len(gs.GnPlan("streamed").args()) == len(fields)
    assert [gs.GnPlan(i).args()[0] for i in gs.INSTANCES] == [0, 1, 2]


def test_bind_gives_each_entry_its_argument_types():
    class Entry:
        argtypes = restype = None

    lib = types.SimpleNamespace(medvae_gn_swish_fwd_bf16=Entry(), medvae_gn_swish_bwd_f32=Entry())
    fwd = gs.bind(lib, "gn_swish_fwd", torch.bfloat16)
    bwd = gs.bind(lib, "gn_swish_bwd", torch.float32)
    ints = 4 + 7  # b, c, h·w, G and the plan
    assert fwd.argtypes == [ctypes.c_void_p] * 7 + [ctypes.c_int] * ints + [ctypes.c_float, ctypes.c_void_p]
    assert bwd.argtypes == [ctypes.c_void_p] * 10 + [ctypes.c_int] * ints + [ctypes.c_void_p]


def test_every_kernel_of_the_source_is_profiled_as_b6_or_b7(chip_smoke):
    """chip_smoke's profile sorts kernels by name fragment; a renamed kernel
    must not drift into "elementwise"."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s*)?(\w+)\s*\(",
                       CSRC.read_text())
    assert len(names) == 11, names
    for name in names:
        # the demangled and the mangled forms the profiler may report
        for key in (f"void (anonymous namespace)::{name}<__nv_bfloat16, true>(int)",
                    f"_ZN51_GLOBAL__N__06f8e9ef_18_groupnorm_swish_cu_de62253e{len(name)}{name}IfEEvPKT_"):
            want = "gn_swish_bwd (B7)" if name.startswith("gn_bwd") else "gn_swish_fwd (B6)"
            assert chip_smoke._category(key) == want, (name, chip_smoke._category(key))
