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
  * `fused_group_norm_swish_or_none` -> the same name, the gate.
The kernels are built by ops/_build.py at first use.

The port's activations are NCHW, so the wrappers take (b, c, h, w) x, where
the JAX package takes NHWC. On CUDA tensors a wrapper launches its kernel
(bf16 or fp32 x; fp32 (c,) γ, β) or raises; it uses the plain PyTorch version
only for tensors on the CPU. Each launch adds one to that kernel's count in
`launches`.
"""

from __future__ import annotations

import ctypes
import os
import threading
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

# a row (one image's channel, h·w elements) is cut into pieces, each
# reduced by one warp, until about this many warps are in flight (64 a
# streaming multiprocessor) or a piece would fall under MIN_PIECE elements
_WARPS_PER_SM = 64
_MIN_PIECE = 1024


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def splits_for(rows: int, hw: int, sms: int) -> int:
    """How many pieces each of `rows` rows of `hw` elements is cut into for
    the reductions, on a card of `sms` streaming multiprocessors."""
    want = -(-(sms * _WARPS_PER_SM) // rows)
    return max(1, min(want, hw // _MIN_PIECE))


def _kernel(name: str, dtype: torch.dtype):
    fn = _fns.get((name, dtype))
    if fn is None:
        from medvae_tpu_torch.ops import _build

        symbol, n_ptrs, takes_eps = _KERNELS[name]
        fn = getattr(_build.load("groupnorm_swish"),
                     symbol + ("_bf16" if dtype == torch.bfloat16 else "_f32"))
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + ([ctypes.c_float] if takes_eps else []) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[(name, dtype)] = fn
    return fn


def _launch(name: str, tensors, x: torch.Tensor, num_groups: int, splits: int, *eps) -> None:
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(name, x.dtype)(
            *(t.data_ptr() for t in tensors), b, c, h * w, num_groups, splits, *eps, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
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


def _splits(x: torch.Tensor) -> int:
    b, c, h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return splits_for(b * c, h * w, sms)


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
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) through kernel B6."""
    if _on_cpu(x, weight, bias):
        return group_norm_swish_fwd_plain(x, weight, bias, num_groups, eps)
    _check(x, weight, bias, num_groups)
    b, c, h, w = x.shape
    splits = _splits(x)
    y = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    ws = torch.empty((2 * b * c * splits,), dtype=torch.float32, device=x.device)
    _launch("gn_swish_fwd", (x, weight, bias, y, mean, rstd, ws), x, num_groups, splits, float(eps))
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
    mean: torch.Tensor, rstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dγ, dβ) through kernel B7; mean and rstd are B6's (b, G) outputs."""
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
    splits = _splits(x)
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    ws = torch.empty((2 * b * c * splits + 2 * b * groups,), dtype=torch.float32, device=x.device)
    _launch("gn_swish_bwd", (x, g, weight, bias, mean, rstd, dx, dgamma, dbeta, ws), x,
            groups, splits)
    return dx, dgamma, dbeta


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
    """(b, c, h, w) → silu(group_norm(x)·γ + β) through B6 (and B7 under
    autograd), or None, the caller's cue to take the plain GroupNorm → cast →
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
    return group_norm_swish_fwd(x, weight, bias, num_groups, eps)[0]
