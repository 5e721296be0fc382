"""Fused GroupNorm + affine + SiLU: the CUDA kernels B6 (forward) and B7
(backward), their plain versions, the autograd Function and the gate.

Counterparts of medvae_tpu/ops/groupnorm_swish.py:
  * B6 `_fwd_kernel` -> csrc/groupnorm_swish.cu, forward: silu(xhat·γ + β)
    with fp32 group statistics, z and SiLU in fp32, one cast to x's dtype;
    it also returns the (b, G) fp32 mean and rstd, which training saves;
  * B7 `_bwd_kernel` -> csrc/groupnorm_swish.cu, backward: dx, dγ, dβ from
    x, the incoming gradient and the saved statistics; dγ and dβ are reduced
    over batch and space in a fixed order (no atomics), so a step is
    repeatable bit for bit;
  * the `jax.custom_vjp` -> `GroupNormSwish` (saves x, γ, β and the stats);
  * `fused_group_norm_swish_or_none` -> the same name, the gate; without
    autograd it calls B6 as the torch.library op `medvae::gn_swish_fwd`
    (`gn_swish_fwd`), which torch.export keeps as one node.
The kernels are built by ops/_build.py at first use. `gn_swish_plan` picks
how they run at a shape (the instance: a group resident in one block's shared
memory, spread over a thread-block cluster, or streamed from device memory
twice) and `gn_swish_instance` names it; B6 is one launch, B7 two (one for
the streamed instance's three kernels each way).

The port's activations are NCHW, so the wrappers take (b, c, h, w) x, where
the JAX package takes NHWC. On CUDA tensors a wrapper launches its kernel
(bf16 or fp32 x; fp32 (c,) γ, β) or raises; it uses the plain PyTorch version
only for tensors on the CPU. Each wrapper call adds one to that kernel's
count in `launches` where it launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import threading
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

# kernel launches by kernel; chip_smoke.py resets and reads them around the
# main path
launches = {"gn_swish_fwd": 0, "gn_swish_bwd": 0}
_count_lock = threading.Lock()

_SUPPORTED = (torch.bfloat16, torch.float32)
# kernel -> (C symbol prefix, number of pointer arguments, takes eps)
_KERNELS = {
    "gn_swish_fwd": ("medvae_gn_swish_fwd", 7, True),
    "gn_swish_bwd": ("medvae_gn_swish_bwd", 10, False),
}
_fns = {}

# streamed: a row (one image's channel, h·w elements) is cut into pieces,
# each reduced by one warp, until about this many warps are in flight (64 a
# streaming multiprocessor) or a piece would fall under MIN_PIECE elements
_WARPS_PER_SM = 64
_MIN_PIECE = 1024

# the plan's limits, as csrc/groupnorm_swish.cu has them
INSTANCES = ("resident", "cluster", "streamed")
SMEM_MAX = 232_448  # 227 KB, a block's most on sm_90
_HEADER = 3072  # mbarriers, reduction scratch, per-channel and the cluster's partials
_MAX_CLUSTER = 8  # the portable cluster size
_MAX_CG = 32  # channels of a group a block reduces (its partials sit in the header)
_MAX_STAGES = 8
_SPAN_MAX = 64 * 1024  # resident: a span of the fewest whole groups holds at most this
_SPAN_TARGET = 32 * 1024  # resident: spans are grown towards this
# resident: the threads that reduce one group, by its length (up to 256, 1024
# and 2048 elements: a segment of 8, 16 or 32 lanes of a warp; past that the
# block's 256)
_LANES = ((256, 8), (1024, 16), (2048, 32))
_SLICE_TARGET = 55 * 1024  # cluster: a slice this small lets four blocks share an SM
_THREADS = 256  # the reducing threads of a block
_WARPS = _THREADS // 32


@dataclass(frozen=True)
class GnPlan:
    """How B6 or B7 runs at one shape (csrc/groupnorm_swish.cu's `Plan`):
    the instance; resident: whole groups a span, ring stages, threads a group
    (8, 16 or 32 lanes of a warp, or the block's 256); cluster: blocks a
    cluster; streamed: pieces a row; and the dynamic shared memory a block
    uses (`plan_smem`), which the kernel checks against its own count. The
    resident instance's persistent grid is sized at launch, by the occupancy
    the kernel's registers and this shared memory allow."""

    instance: str
    groups_per_span: int = 0
    stages: int = 0
    cluster: int = 0
    splits: int = 0
    lanes: int = 0
    smem_bytes: int = 0

    def args(self) -> tuple:
        return (INSTANCES.index(self.instance), self.groups_per_span, self.stages, self.cluster,
                self.splits, self.lanes, self.smem_bytes)


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def splits_for(rows: int, hw: int, sms: int) -> int:
    """How many pieces each of `rows` rows of `hw` elements is cut into for
    the streamed instance's reductions, on a card of `sms` streaming
    multiprocessors."""
    want = -(-(sms * _WARPS_PER_SM) // rows)
    return max(1, min(want, hw // _MIN_PIECE))


def _slice_len(length: int, n: int) -> int:
    return (-(-length // n) + 7) // 8 * 8


def plan_smem(plan: GnPlan, length: int, elem_bytes: int, backward: bool) -> int:
    """The dynamic shared memory `plan`'s kernel uses at groups of `length`
    elements of `elem_bytes` bytes (x; x and g for B7), as the CUDA source
    counts it; the card tests and scripts/gn_variants.py recount a plan they
    change with `dataclasses.replace`."""
    nbuf = 2 if backward else 1
    if plan.instance == "resident":
        return _HEADER + plan.stages * plan.groups_per_span * length * elem_bytes * nbuf
    if plan.instance == "cluster":
        return _HEADER + _slice_len(length, plan.cluster) * elem_bytes * nbuf
    return 0


def _instance_for(length: int, cg: int, elem_bytes: int, backward: bool) -> str:
    """resident, if a span of the fewest whole groups whose bytes are a
    multiple of 16 holds at most 64 KB (and a group of more than 2048
    elements, which the whole block reduces, has at most 32 channels);
    cluster, else, if the group has at most 32 channels and a slice of a
    cluster of 8 fits a block; streamed, else."""
    nbuf = 2 if backward else 1
    k_min = 16 // math.gcd(length * elem_bytes, 16)
    if k_min * length * elem_bytes * nbuf <= _SPAN_MAX and (length <= _LANES[-1][0] or cg <= _MAX_CG):
        return "resident"
    if cg <= _MAX_CG and _HEADER + _slice_len(length, _MAX_CLUSTER) * elem_bytes * nbuf <= SMEM_MAX:
        return "cluster"
    return "streamed"


def gn_swish_plan(shape, elem_bytes: int, num_groups: int, sms: int, backward: bool = False,
                  instance: Optional[str] = None) -> GnPlan:
    """The plan of B6 (or B7 with `backward`) at NCHW `shape` of elements of
    `elem_bytes` bytes, on a card of `sms` SMs. A group is L = (c / G)·h·w
    contiguous elements, held in shared memory once (x; x and g for B7); the
    instance is `_instance_for`'s, or `instance` where the caller forces one
    (chip_smoke times the streamed instance beside the others):
      * resident: spans grown towards 32 KB (but no more than two stages of
        them fit a block), two ring stages, a segment of 8, 16 or 32 lanes a
        group up to 256, 1024 or 2048 elements, else the block's 256
        threads;
      * cluster: the smallest cluster of 2, 4 or 8 whose slices hold at most
        55 KB (four blocks an SM), or 8 if a slice fits a block;
      * streamed: `splits_for`'s pieces a row.
    A forced instance the kernels cannot take at this shape raises
    ValueError."""
    b, c = int(shape[0]), int(shape[1])
    hw = int(shape[2]) * int(shape[3])
    cg = c // num_groups
    length = cg * hw
    nbuf = 2 if backward else 1
    instance = instance or _instance_for(length, cg, elem_bytes, backward)
    if instance == "streamed":
        return GnPlan("streamed", splits=splits_for(b * c, hw, sms))
    if instance == "resident":
        group_bytes = length * elem_bytes * nbuf
        k_min = 16 // math.gcd(length * elem_bytes, 16)
        lanes = next((n for top, n in _LANES if length <= top), _THREADS)
        # segments: a span holds a group for each segment of the block
        unit = max(k_min, _WARPS * 32 // lanes) if lanes <= 32 else k_min
        span = unit * max(1, _SPAN_TARGET // (unit * group_bytes))
        span = min(span, unit * -(-b * num_groups // unit),
                   (SMEM_MAX - _HEADER) // (2 * group_bytes) // k_min * k_min)
        plan = GnPlan("resident", groups_per_span=span, stages=2, lanes=lanes)
        plan = replace(plan, smem_bytes=plan_smem(plan, length, elem_bytes, backward))
        if span < 1 or plan.smem_bytes > SMEM_MAX or lanes == _THREADS and cg > _MAX_CG:
            raise ValueError(f"gn_swish_plan: no resident plan at {tuple(shape)} "
                             f"({plan.smem_bytes} bytes of shared memory, {cg} channels a group)")
        return plan
    if instance != "cluster":
        raise ValueError(f"gn_swish_plan: unknown instance {instance!r}")
    cluster = next((n for n in (2, 4, 8)
                    if _slice_len(length, n) * elem_bytes * nbuf <= _SLICE_TARGET), _MAX_CLUSTER)
    plan = GnPlan("cluster", cluster=cluster)
    plan = replace(plan, smem_bytes=plan_smem(plan, length, elem_bytes, backward))
    if cg > _MAX_CG or plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"gn_swish_plan: no cluster plan at {tuple(shape)} "
                         f"({cg} channels a group, {plan.smem_bytes} bytes of shared memory)")
    return plan


def gn_swish_instance(shape, dtype: torch.dtype, backward: bool = False, num_groups: int = 32) -> str:
    """The instance B6 (or B7) takes at `shape` in `dtype`: "resident",
    "cluster" or "streamed"."""
    groups = min(num_groups, int(shape[1]))
    cg = int(shape[1]) // groups
    elem = torch.empty((), dtype=dtype).element_size()
    return _instance_for(cg * int(shape[2]) * int(shape[3]), cg, elem, backward)


def _kernel(name: str, dtype: torch.dtype):
    fn = _fns.get((name, dtype))
    if fn is None:
        from medvae_tpu_torch.ops import _build

        fn = bind(_build.load("groupnorm_swish"), name, dtype)
        _fns[(name, dtype)] = fn
    return fn


def bind(lib: ctypes.CDLL, name: str, dtype: torch.dtype):
    """Kernel `name`'s C entry for `dtype` in `lib` (the committed build, or
    a variant's), with its argument types."""
    symbol, n_ptrs, takes_eps = _KERNELS[name]
    fn = getattr(lib, symbol + ("_bf16" if dtype == torch.bfloat16 else "_f32"))
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * (4 + len(GnPlan("streamed").args()))
                   + ([ctypes.c_float] if takes_eps else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, tensors, x: torch.Tensor, num_groups: int, plan: GnPlan, *eps) -> None:
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(name, x.dtype)(
            *(t.data_ptr() for t in tensors), b, c, h * w, num_groups, *plan.args(), *eps, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({plan.instance}): CUDA error {err}")
    with _count_lock:
        launches[name] += 1


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
           *more: torch.Tensor) -> None:
    """What the kernels take: contiguous, 16-byte aligned (b, c, h, w) x (and
    `more` of the same kind: the incoming gradient) in bf16 or fp32 on the
    card, c a multiple of num_groups, fp32 (c,) weight and bias."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_swish: unsupported device {x.device}")
    if x.dim() != 4 or any(t.shape != x.shape for t in more):
        raise ValueError(
            f"group_norm_swish expects (b, c, h, w) x and gradient of one shape; got "
            f"{[tuple(t.shape) for t in (x, *more)]}"
        )
    if x.dtype not in _SUPPORTED or any(t.dtype != x.dtype for t in more):
        raise TypeError(
            f"group_norm_swish takes bf16 or fp32 x of one dtype; got "
            f"{[t.dtype for t in (x, *more)]}"
        )
    c = x.shape[1]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"group_norm_swish: {c} channels do not split into {num_groups} groups")
    if x.numel() >= 2**31:
        raise ValueError(f"group_norm_swish: {x.numel()} elements, the kernels take < 2^31")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(
                f"group_norm_swish: {name} must be fp32 ({c},) on {x.device}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if any(t.device != x.device for t in more):
        raise ValueError("group_norm_swish: x and the gradient lie on different devices")
    for name, t in zip(("x", "gradient"), (x, *more)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"group_norm_swish: {name} must be contiguous and 16-byte aligned")
    if not weight.is_contiguous() or not bias.is_contiguous():
        raise ValueError("group_norm_swish: weight and bias must be contiguous")


def plan_for(x: torch.Tensor, num_groups: int, backward: bool = False,
             instance: Optional[str] = None) -> GnPlan:
    """gn_swish_plan for x on its card, planned once a shape (a step calls
    the wrappers at the same few shapes again and again)."""
    return _plan_on(tuple(x.shape), x.element_size(), num_groups, backward, x.device.index, instance)


@functools.lru_cache(maxsize=1024)
def _plan_on(shape: tuple, elem_bytes: int, num_groups: int, backward: bool, device: int,
             instance: Optional[str]) -> GnPlan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return gn_swish_plan(shape, elem_bytes, num_groups, sms, backward, instance)


def _workspace(plan: GnPlan, x: torch.Tensor, num_groups: int, backward: bool) -> torch.Tensor:
    """fp32 scratch: the streamed instance's row partials (and its (b, G)
    group means in B7), or B7's (c, 2, b) per-channel sums."""
    b, c = x.shape[:2]
    if plan.instance == "streamed":
        n = 2 * b * c * plan.splits + (2 * b * num_groups if backward else 0)
    else:
        n = 2 * b * c if backward else 0
    return torch.empty((max(n, 1),), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------------ B6 ---- #


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 input (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def group_stats_plain(x: torch.Tensor, num_groups: int, eps: float):
    """(mean, rstd) of each (image, group) of NCHW x, (b, G) in fp32."""
    b = x.shape[0]
    xg = x.to(_acc_dtype(x)).reshape(b, num_groups, -1)
    mean = xg.mean(dim=-1)
    var = (xg - mean[..., None]).square().mean(dim=-1)
    return mean, torch.rsqrt(var + eps)


def group_norm_swish_fwd_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B6's function in PyTorch: (y, mean, rstd). The group statistics,
    xhat·γ + β and SiLU in fp32; y cast once to x's dtype."""
    b, c = x.shape[:2]
    acc = _acc_dtype(x)
    mean, rstd = group_stats_plain(x, num_groups, eps)
    xg = x.to(acc).reshape(b, num_groups, c // num_groups, -1)
    xhat = (xg - mean[:, :, None, None]) * rstd[:, :, None, None]
    z = xhat.reshape(b, c, -1) * weight.to(acc)[:, None] + bias.to(acc)[:, None]
    return (z * torch.sigmoid(z)).reshape(x.shape).to(x.dtype), mean, rstd


def group_norm_swish_plain(x, weight, bias, num_groups: int, eps: float) -> torch.Tensor:
    """B6's function without the statistics."""
    return group_norm_swish_fwd_plain(x, weight, bias, num_groups, eps)[0]


def group_norm_swish_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    plan: Optional[GnPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) through kernel B6, on `plan` (`plan_for`'s by
    default)."""
    if _on_cpu(x, weight, bias):
        return group_norm_swish_fwd_plain(x, weight, bias, num_groups, eps)
    _check(x, weight, bias, num_groups)
    b = x.shape[0]
    plan = plan or plan_for(x, num_groups)
    y = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    ws = _workspace(plan, x, num_groups, False)
    _launch("gn_swish_fwd", (x, weight, bias, y, mean, rstd, ws), x, num_groups, plan, float(eps))
    return y, mean, rstd


# ------------------------------------------------------------------ B7 ---- #


def group_norm_swish_bwd_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B7's function in PyTorch, written out as the TPU kernel does
    (medvae_tpu/ops/groupnorm_swish.py:166-218) from the (b, G) statistics:
    dz = g·σ(z)(1 + z(1 − σ(z))); dγ = Σ dz·xhat and dβ = Σ dz over batch and
    space; dx = rstd·(dxhat − mean_g(dxhat) − xhat·mean_g(dxhat·xhat)) with
    dxhat = dz·γ. dx in x's dtype, dγ and dβ in fp32."""
    b, c = x.shape[:2]
    groups = mean.shape[1]
    acc = _acc_dtype(x)
    shape = (b, groups, c // groups, -1)
    xhat = (x.to(acc).reshape(shape) - mean[:, :, None, None]) * rstd[:, :, None, None]
    gamma = weight.to(acc).reshape(1, groups, c // groups, 1)
    z = xhat * gamma + bias.to(acc).reshape(1, groups, c // groups, 1)
    sig = torch.sigmoid(z)
    dz = g.to(acc).reshape(shape) * sig * (1.0 + z * (1.0 - sig))
    dgamma = (dz * xhat).sum(dim=(0, 3)).reshape(c)
    dbeta = dz.sum(dim=(0, 3)).reshape(c)
    dxhat = dz * gamma
    m1 = dxhat.mean(dim=(2, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(2, 3), keepdim=True)
    dx = rstd[:, :, None, None] * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


def group_norm_swish_bwd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, plan: Optional[GnPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dγ, dβ) through kernel B7, on `plan` (`plan_for`'s by default);
    mean and rstd are B6's (b, G) outputs."""
    if _on_cpu(x, weight, bias, g, mean, rstd):
        return group_norm_swish_bwd_plain(x, weight, bias, g, mean, rstd)
    b, c, h, w = x.shape
    groups = mean.shape[1] if mean.dim() == 2 else 0
    _check(x, weight, bias, groups, g)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.shape != (b, groups) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(
                f"group_norm_swish backward: {name} must be contiguous fp32 ({b}, {groups}) "
                f"on {x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    plan = plan or plan_for(x, groups, backward=True)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    ws = _workspace(plan, x, groups, True)
    _launch("gn_swish_bwd", (x, g, weight, bias, mean, rstd, dx, dgamma, dbeta, ws), x,
            groups, plan)
    return dx, dgamma, dbeta


@torch.library.custom_op("medvae::gn_swish_fwd", mutates_args=(), device_types=("cpu", "cuda"))
def gn_swish_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                 eps: float) -> torch.Tensor:
    """B6 without its statistics as the op `medvae::gn_swish_fwd`, the
    serving forward: one node of a torch.export graph. Its kernel is
    `group_norm_swish_fwd` on a contiguous copy of x: on the card it plans
    (`plan_for`), allocates the workspace and launches B6 inside the op
    (raising, counted), so no host-side state is an argument; on the CPU it
    is the plain version. The copy: an exported graph keeps the eager path's
    `x.contiguous()` only where the trace's fake x was not contiguous, and
    on the card the 224² flagship's graph handed the op a non-contiguous x."""
    return group_norm_swish_fwd(x.contiguous(), weight, bias, num_groups, eps)[0]


@gn_swish_fwd.register_fake
def _gn_swish_fwd_fake(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                       eps: float) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


class GroupNormSwish(torch.autograd.Function):
    """silu(group_norm(x)·γ + β) with B6 forward and B7 backward: the port of
    the JAX package's custom_vjp (medvae_tpu/ops/groupnorm_swish.py:87-103),
    which saves x, γ and β; this one also keeps B6's (b, G) statistics
    (8 bytes a group) so that B7 need not recompute them."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        y, mean, rstd = group_norm_swish_fwd(x, weight, bias, num_groups, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_swish_bwd(
            x, weight, bias, g.to(x.dtype).contiguous(), mean, rstd
        )
        return dx, dgamma.to(weight.dtype), dbeta.to(bias.dtype), None, None


def fused_group_norm_swish_or_none(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> Optional[torch.Tensor]:
    """(b, c, h, w) → silu(group_norm(x)·γ + β) through B6 (the op, or the
    Function with B7 under autograd), or None, the caller's cue to take the plain GroupNorm → cast →
    SiLU path. Opt-in, as in the JAX package: only with MEDVAE_FUSED_GN=1, read
    at every call as the JAX gate reads it, and only where c splits into the
    groups. The TPU gate's h·w·c cap (medvae_tpu/ops/groupnorm_swish.py:81-83)
    is a VMEM limit and is not kept: the kernels take every trunk shape."""
    if os.environ.get("MEDVAE_FUSED_GN") != "1":
        return None
    if x.shape[1] % num_groups:
        return None
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return GroupNormSwish.apply(x, weight, bias, num_groups, eps)
    return gn_swish_fwd(x, weight, bias, num_groups, eps)
