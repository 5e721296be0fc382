"""NN building blocks (counterpart of medvae_tpu/nn/blocks.py).

NCHW inside, as PyTorch's convolutions want. Module and parameter names follow
the reference torch layout (norm1/conv1/norm2/conv2/nin_shortcut, norm/q/k/v/
proj_out) so that state_dicts line up with it.

Numerics follow the JAX blocks: a conv casts its input, weight and bias to the
compute dtype, like a flax Conv with `dtype=` set; GroupNorm(min(32, C), eps
1e-6) computes in fp32 with fp32 affine params and is cast back to the
activation dtype. The compute dtype is a conv's `compute_dtype` attribute
when set (training: fp32 params cast at every call, as flax does) and else
the dtype its weight is stored in (serving: weights pre-cast once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from medvae_tpu_torch.ops.attention import attention
from medvae_tpu_torch.ops.groupnorm_swish import fused_group_norm_swish_or_none


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its compute dtype, like a flax Conv with `dtype=` set:
    input, weight and bias are cast at every call."""

    compute_dtype: torch.dtype | None = None  # None: the weight's storage dtype

    def cast_params(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self.weight.to(dt), bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.cast_params()
        return self._conv_forward(x.to(weight.dtype), weight, bias)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every Conv2d under `module` computes in `dtype`."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype


class GroupNorm(nn.GroupNorm):
    """GroupNorm(min(32, C), eps=1e-6) in fp32, cast back to the input dtype."""

    def __init__(self, num_channels: int):
        super().__init__(min(32, num_channels), num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(
            x.float(), self.num_groups, self.weight, self.bias, self.eps
        ).to(x.dtype)


def norm_swish(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm (fp32 stats) -> cast back -> SiLU (medvae_tpu/nn/blocks.py:47-62).
    With MEDVAE_FUSED_GN=1 the whole norm + affine + SiLU runs as the fused
    kernels B6/B7 (ops/groupnorm_swish.py), with SiLU in fp32 before the one
    cast, as the JAX package's fused kernel has it. `norm`'s weight and bias
    are the params either way, so state_dicts are the same."""
    out = fused_group_norm_swish_or_none(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
    if out is not None:
        return out
    return swish(norm(x))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's nn.Dropout: keep each element with probability 1 − rate and
    scale the kept ones by 1 / (1 − rate); the mask is drawn from `generator`
    (the train step's, on x's device; the default one when None)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ResnetBlock(nn.Module):
    """GN -> swish -> 3x3 conv, twice, plus a 1x1 nin shortcut on a channel
    change. Dropout at `dropout` before the second conv in train mode, where
    medvae_tpu/nn/blocks.py:140 places it; off in eval mode."""

    def __init__(self, in_channels: int, out_channels: int | None = None, dropout: float = 0.0):
        super().__init__()
        out_channels = out_channels or in_channels
        self.dropout = float(dropout)
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)
        else:
            self.nin_shortcut = None

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.conv1(norm_swish(self.norm1, x))
        h = norm_swish(self.norm2, h)
        if self.dropout and self.training:
            h = dropout(h, self.dropout, generator)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the h·w token grid, with residual add.

    The 1x1 q/k/v/proj_out convs run as matmuls on the (b, h·w, c) token
    layout, which is the layout the attention kernel takes, so q, k and v come
    out contiguous with no transpose copy each."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm(c)
        self.q = Conv2d(c, c, 1)
        self.k = Conv2d(c, c, 1)
        self.v = Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    @staticmethod
    def _linear(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        w, b = conv.cast_params()
        return F.linear(x.to(w.dtype), w.view(w.shape[0], w.shape[1]), b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h_ = self.norm(x).flatten(2).transpose(1, 2)  # (b, h·w, c)
        q = self._linear(self.q, h_)
        k = self._linear(self.k, h_)
        v = self._linear(self.v, h_)
        out = attention(q, k, v).to(x.dtype)
        out = self._linear(self.proj_out, out)
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class Downsample(nn.Module):
    """Stride-2 3x3 conv after the reference's asymmetric (0,1,0,1) pad."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
