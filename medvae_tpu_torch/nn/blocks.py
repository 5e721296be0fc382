"""NN building blocks (counterpart of medvae_tpu/nn/blocks.py).

NCHW inside, as PyTorch's convolutions want. Module and parameter names follow
the reference torch layout (norm1/conv1/norm2/conv2/nin_shortcut, norm/q/k/v/
proj_out, to_qkv/to_out) so that state_dicts line up with it.

Numerics follow the JAX blocks: a conv casts its input, weight and bias to the
compute dtype, like a flax Conv with `dtype=` set; GroupNorm(min(32, C), eps
1e-6) computes in fp32 with fp32 affine params and is cast back to the
activation dtype. The compute dtype is a conv's `compute_dtype` attribute
when set (training: fp32 params cast at every call, as flax does) and else
the dtype its weight is stored in (serving: weights pre-cast once). A
Linear of the trunk or the conditioning (`dense`) computes in the dtype its
caller names, as a flax Dense with `dtype=` does.
"""

from __future__ import annotations

import functools
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from medvae_tpu_torch.ops.attention import attention
from medvae_tpu_torch.ops.groupnorm_swish import fused_group_norm_swish_or_none


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its compute dtype, like a flax Conv with `dtype=` set:
    input, weight and bias are cast at every call. Under tensor parallelism
    `column` holds the weight's shard (parallel/tensor_parallel.py), and the
    conv computes its rows and gathers the rest."""

    compute_dtype: torch.dtype | None = None  # None: the weight's storage dtype
    column = None  # parallel/tensor_parallel.py:ColumnShard when sharded

    def cast_params(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self.weight.to(dt), bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.cast_params()
        if self.column is not None:
            return self.column.conv(self, x.to(weight.dtype), weight, bias)
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


def group_norm(num_channels: int) -> GroupNorm:
    """GroupNorm(min(32, C), eps=1e-6) with affine params, the reference's
    Normalize (medvae_tpu/nn/blocks.py:30-44)."""
    return GroupNorm(num_channels)


class GroupNormSwish(GroupNorm):
    """GroupNorm + affine + SiLU as one module, with nn.GroupNorm's `weight`
    and `bias` (medvae_tpu/nn/blocks.py:65-85): through B6 (B7 under
    autograd) where `fused_group_norm_swish_or_none` takes the call (on
    the card by default), else the plain GroupNorm -> cast -> SiLU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = fused_group_norm_swish_or_none(x, self.weight, self.bias, self.num_groups, self.eps)
        return swish(super().forward(x)) if out is None else out


def norm_swish(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm (fp32 stats) -> cast back -> SiLU (medvae_tpu/nn/blocks.py:47-62).
    Where the gate takes the call (on the card by default, everywhere with
    MEDVAE_FUSED_GN=1, nowhere with 0) the whole norm + affine + SiLU runs
    as the fused kernels B6/B7 (ops/groupnorm_swish.py), with SiLU in fp32
    before the one cast, as the JAX package's fused kernel has it. `norm`'s
    weight and bias are the params either way, so state_dicts are the same."""
    out = fused_group_norm_swish_or_none(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
    if out is not None:
        return out
    return swish(norm(x))


class _MaskTape:
    """The dropout masks of one rematerialized call: drawn from the step's
    generator on the call's first run, handed back in order on each
    recompute. `torch.utils.checkpoint` restores only the default
    generators' states, and the port draws its masks from the step's own
    (`dropout`), so a recompute that drew again would drop other elements
    than the forward did and give wrong gradients."""

    def __init__(self):
        self.masks: list = []
        self.runs = 0
        self.replaying = False
        self.next = 0


_tapes = threading.local()  # each thread's stack of the tapes of calls running on it


def _tape_stack() -> list:
    if not hasattr(_tapes, "stack"):
        _tapes.stack = []
    return _tapes.stack


def _keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """A fresh mask, or the forward's where a rematerialized call is being
    recomputed; recorded by every recording call around it (the outermost
    replaying call serves a nested one's first run)."""
    stack = _tape_stack()
    replay = next((t for t in stack if t.replaying), None)
    if replay is not None:
        mask = replay.masks[replay.next]
        replay.next += 1
    else:
        mask = torch.rand(shape, generator=generator, device=device) < keep
    for tape in stack:
        if not tape.replaying:
            tape.masks.append(mask)
    return mask


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The "conv" rung's policy: keep the convolutions' outputs, recompute
    the rest (the JAX rung's save_only_these_names("resblock_conv"))."""
    if op is torch.ops.aten.convolution.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, save_convs: bool = False):
    """`fn(*args)` with its activations rematerialized in the backward pass
    (non-reentrant `torch.utils.checkpoint`), its dropout masks taped
    (`_MaskTape`); `save_convs` keeps the convolutions' outputs."""
    tape = _MaskTape()

    def run(*inner):
        tape.replaying, tape.next = tape.runs > 0, 0
        tape.runs += 1
        stack = _tape_stack()
        stack.append(tape)
        try:
            return fn(*inner)
        finally:
            stack.pop()

    kwargs = {}
    if save_convs:
        kwargs["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                 _save_conv_outputs)
    return ckpt.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's nn.Dropout: keep each element with probability 1 − rate and
    scale the kept ones by 1 / (1 − rate); the mask is drawn from `generator`
    (the train step's, on x's device; the default one when None), or inside
    a rematerialized call's recompute taken from its tape."""
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`linear` with its input, weight and bias cast to `dtype`, as a flax
    Dense with `dtype=` computes."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    column = getattr(linear, "column", None)  # tensor parallelism's shard
    if column is not None:
        return column.linear(x.to(dtype), linear.weight.to(dtype), bias)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


class ResnetBlock(nn.Module):
    """GN -> swish -> 3x3 conv, twice, plus a 1x1 nin shortcut on a channel
    change (a 3x3 `conv_shortcut` with `conv_shortcut=True`,
    medvae_tpu/nn/blocks.py:145-151). Dropout at `dropout` before the
    second conv in train mode, where medvae_tpu/nn/blocks.py:140 places it;
    off in eval mode. With
    `temb_channels` it owns `temb_proj`, and a temb given to forward adds
    Dense(swish(temb)) after conv1 (medvae_tpu/nn/blocks.py:134-137); flax
    creates that Dense only where a temb is passed, so only the encoder of
    the `inject` ConditionalVAE builds it.

    `remat` ("block", "conv" or False; set by encoder_decoder.set_remat)
    rematerializes the block in training's backward pass: "block" keeps only
    its input, "conv" its convolutions' outputs too."""

    remat: str | bool = False

    def __init__(self, in_channels: int, out_channels: int | None = None, dropout: float = 0.0,
                 temb_channels: int = 0, conv_shortcut: bool = False):
        super().__init__()
        out_channels = out_channels or in_channels
        self.dropout = float(dropout)
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels:
            self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = self.conv_shortcut = None
        if in_channels != out_channels and conv_shortcut:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 3, padding=1)
        elif in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None,
        temb: torch.Tensor | None = None,
    ) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self._forward, x, generator, temb, save_convs=self.remat == "conv")
        return self._forward(x, generator, temb)

    def _forward(self, x: torch.Tensor, generator: torch.Generator | None,
                 temb: torch.Tensor | None) -> torch.Tensor:
        h = self.conv1(norm_swish(self.norm1, x))
        if temb is not None:
            h = h + dense(self.temb_proj, swish(temb), h.dtype)[:, :, None, None]
        h = norm_swish(self.norm2, h)
        if self.dropout and self.training:
            h = dropout(h, self.dropout, generator)
        h = self.conv2(h)
        shortcut = self.nin_shortcut or self.conv_shortcut
        if shortcut is not None:
            x = shortcut(x)
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
        if conv.column is not None:
            return conv.column.linear(x.to(w.dtype), w.view(w.shape[0], w.shape[1]), b)
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


class LinearAttention(nn.Module):
    """O(n) attention (medvae_tpu/nn/blocks.py:198-225, the reference's
    LinearAttention): a bias-free 1x1 `to_qkv`, the keys' softmax over the
    token axis in fp32, context = k·vᵀ then out = context·q (each product
    accumulated in fp32 and cast to the input's dtype), and a 1x1 `to_out`.
    Channels split as (qkv, head, d), the reference's rearrange."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = int(heads), int(dim_head)
        hidden = self.heads * self.dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        qkv = self.to_qkv(x).reshape(b, 3, self.heads, self.dim_head, hh * ww)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # (b, heads, d, n)
        k = torch.softmax(k.float(), dim=-1).to(x.dtype)
        context = torch.matmul(k.float(), v.float().transpose(-1, -2)).to(x.dtype)  # (b, h, d, e)
        out = torch.matmul(context.float().transpose(-1, -2), q.float()).to(x.dtype)  # (b, h, e, n)
        return self.to_out(out.reshape(b, self.heads * self.dim_head, hh, ww))


class LinAttnBlock(LinearAttention):
    """Single-head linear attention with dim_head = C, no norm and no
    residual (medvae_tpu/nn/blocks.py:228-242). A subclass, as in the
    reference, so its keys are `to_qkv`/`to_out` directly; flax nests them
    under `attn`, which compat/jax_params.py drops."""

    def __init__(self, in_channels: int):
        super().__init__(in_channels, heads=1, dim_head=in_channels)


def make_attn(in_channels: int, attn_type: str = "vanilla") -> nn.Module:
    """The attention block of every attention site (medvae_tpu/nn/blocks.py:245-256)."""
    if attn_type == "vanilla":
        return AttnBlock(in_channels)
    if attn_type == "linear":
        return LinAttnBlock(in_channels)
    raise NotImplementedError(f"Attention type {attn_type} not implemented")


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
