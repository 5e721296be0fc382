"""PatchGAN discriminator (counterpart of medvae_tpu/nn/discriminator.py:16-86).

4×4 convs with padding 1 all round: stride 2 for `conv0` and `conv1` …
`conv{n_layers-1}`, then stride 1 for `conv{n_layers}` and the one-channel
`conv_out`; LeakyReLU(0.2) after every conv but the last, and a norm after
every conv but the first and the last. NHWC in and out, as the JAX module
takes and gives; NCHW inside. Everything computes in fp32: the caller's
images are cast up.

The norm is flax's `nn.BatchNorm`, written out, because torch's BatchNorm2d
differs from it in two ways that move the running statistics:

  * flax's momentum 0.99 keeps 0.99 of the running value (torch's momentum
    0.1 is the share of the batch's);
  * flax stores the biased batch variance (torch the unbiased one).

Batch statistics follow flax's `_compute_stats`: mean E[x] and variance
max(0, E[x²] − E[x]²) over (N, H, W) in fp32, eps 1e-5. In train mode the
norm normalizes by them and then updates `running_mean` and `running_var`
in place (under no_grad); in eval mode it normalizes by the running ones.
`use_actnorm` swaps the norm for GroupNorm(min(32, C), eps 1e-6, the same
fast variance) and drops the convs' biases but `conv_out`'s.

Module names are the flax ones (`conv0`, `norm1`, …, `conv_out`), so
compat/jax_params.py:from_jax_disc_variables maps a JAX disc's `params` and
`batch_stats` by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_LECUN_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def _fast_stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's mean and fast variance, max(0, E[x²] − E[x]²), in fp32."""
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp(x.square().mean(dim=dims, keepdim=True) - mean.square(), min=0.0)
    return mean, var


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.99, epsilon=1e-5)` on NCHW; see the
    module docstring."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = float(momentum), float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean, var = _fast_stats(x, (0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.flatten())
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var.flatten())
        else:
            mean = self.running_mean.view(1, -1, 1, 1)
            var = self.running_var.view(1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, -1, 1, 1)
        return (x - mean) * mul + self.bias.view(1, -1, 1, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=min(32, C))` (eps 1e-6, fast variance)
    on NCHW; `train` is accepted and ignored."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = min(32, channels), float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = x.reshape(b, self.groups, c // self.groups, h, w)
        mean, var = _fast_stats(xg, (2, 3, 4))
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        norm = GroupNorm if use_actnorm else BatchNorm
        bias = not use_actnorm
        self.n_layers = int(n_layers)
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1, bias=bias)
        planes = ndf
        for n in range(1, self.n_layers + 1):
            out = ndf * min(2**n, 8)
            stride = 2 if n < self.n_layers else 1
            setattr(self, f"conv{n}", nn.Conv2d(planes, out, 4, stride=stride, padding=1, bias=bias))
            setattr(self, f"norm{n}", norm(out))
            planes = out
        self.conv_out = nn.Conv2d(planes, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NHWC images -> NHWC (b, h', w', 1) fp32 logits; `train` uses and
        updates the batch statistics."""
        h = F.leaky_relu(self.conv0(x.float().permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm{n}")(h, train), 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "NLayerDiscriminator":
        """flax's initializers from a seeded CPU generator: conv kernels
        lecun_normal (a normal truncated to ±2 std, scaled to variance
        1/fan_in), biases 0, norm scales 1 and biases 0, running mean 0 and
        variance 1."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                m.weight.copy_(w * (m.weight[0].numel() ** -0.5 / _LECUN_TRUNC_STD))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (BatchNorm, GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        return self


def logit_size(size: int, n_layers: int = 3) -> int:
    """The side of the logit map a size×size image gives: each stride-2 4×4
    conv with padding 1 takes s to ⌊(s − 2)/2⌋ + 1, each stride-1 one to s − 1."""
    for _ in range(int(n_layers)):
        size = (size - 2) // 2 + 1
    return size - 2


def build_discriminator(disc_cfg, device, seed: int) -> NLayerDiscriminator:
    """The discriminator of `training.discriminator` (the JAX Trainer's
    default input_nc 3, ndf 64, n_layers 3 when unset), seeded, on
    `device`, in train mode with grads on its params."""
    cfg = dict(disc_cfg or {"input_nc": 3, "ndf": 64, "n_layers": 3})
    disc = NLayerDiscriminator(**cfg).init_weights(seed)
    return disc.to(device).train().requires_grad_(True)
